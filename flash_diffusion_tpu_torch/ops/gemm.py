"""GEMM ops: the hand-written W8A8 int8 GEMM and its plain version.

Port of ``flash_diffusion_tpu/ops/gemm.py`` ``int8_gemm`` (:226, the
Pallas ``_int8_gemm_kernel`` at :171): ``y = act(float(xq·wqᵀ) · sx · sw +
bias)`` over int8 operands with exact int32 sums, the per-token scale
``sx`` and the per-channel scale ``sw`` applied to the fp32 value, then the
bias, then tanh-gelu if ``act == "gelu"``, then one cast. ``wq`` is
[N, K], the ``nn.Linear`` layout (JAX keeps [K, N]).

- On a CUDA tensor ``int8_gemm`` launches the kernel of
  ``csrc/int8_gemm.cu`` for every shape with K % 32 == 0, or raises; it
  never falls back. JAX's ``int8_gemm_eligible`` (M ≥ 256, K and N
  multiples of 128) is a TPU tiling gate that sends small products to an
  XLA dot with the same numerics; here every int8 product is the kernel's.
- On a CPU tensor it runs ``int8_gemm_reference``, the plain version.

On the card ``out_dtype`` is bf16 (the JAX kernel's output) or int32: the
raw sums, no epilogue (for checks). The plain version also gives fp32, for
an fp32 model on the CPU (JAX's XLA route keeps fp32 there too); the card
serves bf16 and raises for it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import kernels

# Launch count of the int8 GEMM kernel, raised by one per launch (never on
# the plain path). Reset it by assigning 0.
LAUNCHES = {"int8_gemm": 0}
_OUT_KINDS = {torch.bfloat16: 0, torch.int32: 1}


def int8_sums_reference(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Σ_k xq[m, k]·wq[n, k] as int32 [M, N], exactly: the product runs in
    fp64, where every partial sum is an integer far below 2^53 (|sum| ≤
    127²·K), on the CPU and on the card alike (CUDA has no int32 matmul)."""
    return (xq.double() @ wq.double().t()).to(torch.int32)


def int8_gemm_reference(
    xq: torch.Tensor, sx: Optional[torch.Tensor], wq: torch.Tensor, sw: Optional[torch.Tensor],
    bias: Optional[torch.Tensor] = None, act: Optional[str] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain version of the kernel: the int32 sums, then the epilogue in
    fp32 in the kernel's order, then one cast."""
    acc = int8_sums_reference(xq, wq)
    if out_dtype == torch.int32:
        return acc
    y = acc.float() * sx.float()[:, None] * sw.float()[None, :]
    if bias is not None:
        y = y + bias.float()
    if act == "gelu":
        y = F.gelu(y, approximate="tanh")
    return y.to(out_dtype)


def _check_cuda_inputs(xq, sx, wq, sw, bias, act, out_dtype):
    if xq.device.type != "cuda":
        raise ValueError(f"the int8 GEMM kernel runs on CUDA tensors, got {xq.device}")
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"the int8 GEMM kernel's out_dtype is bf16 or int32, got {out_dtype}")
    if act not in (None, "gelu") or (out_dtype == torch.int32 and (act or bias is not None)):
        raise ValueError(f"act must be None or 'gelu' (and None for the int32 sums), got {act!r}")
    for name, t in (("xq", xq), ("wq", wq)):
        if t.dtype != torch.int8 or t.dim() != 2 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned int8 matrix")
    (m, k), n = xq.shape, wq.shape[0]
    if wq.shape[1] != k or k % 32:
        raise ValueError(f"the int8 GEMM kernel needs xq [M, K], wq [N, K] with K % 32 == 0, "
                         f"got {tuple(xq.shape)} and {tuple(wq.shape)}")
    if wq.device != xq.device:
        raise ValueError("xq and wq must be on the same device")
    if out_dtype == torch.int32:
        return
    for name, t, size in (("sx", sx, m), ("sw", sw, n), ("bias", bias, n)):
        if t is None and name == "bias":
            continue
        if (t is None or t.dtype != torch.float32 or t.shape != (size,) or not t.is_contiguous()
                or t.device != xq.device):
            raise ValueError(f"{name} must be a contiguous fp32 [{size}] tensor on {xq.device}")


def int8_gemm(
    xq: torch.Tensor, sx: Optional[torch.Tensor], wq: torch.Tensor, sw: Optional[torch.Tensor],
    bias: Optional[torch.Tensor] = None, act: Optional[str] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """[M, N] = act(float(xq [M, K] int8 · wq [N, K] int8ᵀ) · sx [M] · sw [N]
    + bias [N]) in ``out_dtype``; scales and bias fp32. CPU tensors take the
    plain version; CUDA tensors launch the kernel (bf16 or int32 out)."""
    if xq.device.type == "cpu":
        return int8_gemm_reference(xq, sx, wq, sw, bias, act, out_dtype)
    _check_cuda_inputs(xq, sx, wq, sw, bias, act, out_dtype)
    m, k = xq.shape
    n = wq.shape[0]
    out = torch.empty(m, n, device=xq.device, dtype=out_dtype)
    ptr = lambda t: None if t is None else t.data_ptr()
    if out_dtype == torch.int32:
        sx = sw = bias = None
    with torch.cuda.device(xq.device):
        err = kernels.library().fdt_int8_gemm(
            xq.data_ptr(), wq.data_ptr(), ptr(sx), ptr(sw), ptr(bias), out.data_ptr(), m, n, k,
            _OUT_KINDS[out_dtype], int(act == "gelu"), torch.cuda.current_stream(xq.device).cuda_stream,
        )
    kernels.check(err, "int8_gemm")
    LAUNCHES["int8_gemm"] += 1
    return out
