"""GEMM ops: the hand-written feed-forward GEMMs (K10, K12) and W8A8 int8
GEMM (K11), and their plain versions.

Port of ``flash_diffusion_tpu/ops/gemm.py``. Every kernel wrapper takes its
plain version for a tensor on the CPU; on a CUDA tensor it launches its
kernel or raises, and never falls back.

The down-projection family:

- ``down_proj_gemm(x, w, b)`` (JAX ``down_proj_gemm``, :402): y = x·Wᵀ + b
  through ``DownProjGemmFunction`` → ``gemm``, the port of ``_gemm_kernel``
  (K10, ``csrc/gemm_sm90.cu``: wgmma fed by a TMA ring, persistent, tiles
  by ``gemm_plan``; fp32 accumulator, the bias added in fp32 in the
  epilogue, one cast), for the shapes ``gemm_eligible`` takes and x's
  dtype equal to W's;
  every other call takes the unfused ops (x·Wᵀ, then + b in y's dtype), as
  JAX's does: routing by shape, not a fallback on failure. On the card K10
  is built for bf16: an fp32 call that JAX would send to K10 raises.
- ``geglu_down_proj(x2k, w, b)`` (JAX :374): y = (a · gelu_tanh(g))·Wᵀ + b
  with x2k = [a | g] along the last dim, through ``GegluGemmFunction`` →
  ``geglu_gemm``, the port of ``_geglu_gemm_kernel`` (K12,
  ``csrc/ffn_gemm.cu``: mma.sync, the GEGLU prologue in shared memory),
  for bf16 calls that ``gemm_eligible`` takes; every other call takes the
  unfused ops.
  Rounding contract of K12 and its plain version: h = a · gelu_tanh(g) is
  computed in fp32 from the bf16 inputs and rounded once to bf16, the MMA
  operand; the product accumulates in fp32, b (rounded to x's dtype first)
  is added in fp32, and y is rounded once. JAX in interpret mode rounds its
  bf16 elementwise ops one by one, so the tests hold the two to a
  tolerance.

``gemm_eligible`` is JAX's shape family (:108-124: K ≥ 2N, K ≥ 2048,
128 ≤ N ≤ 2048, N and K multiples of 128, M ≥ 1024, M % 8 == 0). JAX also
asks its TPU VMEM model (``_pick_blocks``, ``_pick_blocks_geglu``) for a
block, which it never refuses inside that family (at N ≤ 2048 the 8-row,
128-deep block takes 0.6 MB of the 8 MB), so the port drops it. The
backward mirrors the JAX custom VJPs in plain PyTorch, with dW = xᵀ·dy of
K10 on the kernel again where ``gemm_eligible(K, M, N)`` holds.

The int8 GEMM: ``int8_gemm`` (:226, the Pallas ``_int8_gemm_kernel`` at
:171): ``y = act(float(xq·wqᵀ) · sx · sw + bias)`` over int8 operands with
exact int32 sums, the per-token scale ``sx`` and the per-channel scale
``sw`` applied to the fp32 value, then the bias, then tanh-gelu if ``act ==
"gelu"``, then one cast. ``wq`` is [N, K], the ``nn.Linear`` layout (JAX
keeps [K, N]).

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

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import kernels

# Launch counts of the kernels, raised by one per launch (never on the plain
# path). Reset them by assigning 0.
LAUNCHES = {"int8_gemm": 0, "gemm": 0, "geglu_gemm": 0}
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


def gemm_eligible(m: int, k: int, n: int) -> bool:
    """The JAX down-projection family (deep contraction into a narrow
    output) that K10 and K12 take; see the module docstring."""
    return (k >= 2 * n and k >= 2048 and 128 <= n <= 2048 and n % 128 == 0 and k % 128 == 0
            and m >= 1024 and m % 8 == 0)


def geglu_h(x2k: torch.Tensor) -> torch.Tensor:
    """a · gelu_tanh(g) with [a | g] = x2k, in x2k's dtype: the JAX
    ``_geglu_h`` (the unfused ops, and the backward's recompute)."""
    a, g = x2k.chunk(2, dim=-1)
    return a * F.gelu(g, approximate="tanh")


def down_proj_gemm_reference(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version of K10: x [M, K] · w [N, K]ᵀ accumulated in fp32 (fp64
    for fp64 inputs), + bias [N] in that type, one cast to x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return (x.to(acc) @ w.to(acc).t() + bias.to(acc)).to(x.dtype)


def geglu_down_proj_reference(x2k: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version of K12 on x2k = [a | g] [M, 2K], with its rounding
    contract: h = a · gelu_tanh(g) in fp32, rounded once to x2k's dtype,
    then K10's product and epilogue."""
    acc = torch.promote_types(x2k.dtype, torch.float32)
    a, g = x2k.to(acc).chunk(2, dim=-1)
    return down_proj_gemm_reference((a * F.gelu(g, approximate="tanh")).to(x2k.dtype), w, bias)


# The gate of K10 and K12 (bf16 out) against their plain versions in fp32 on
# the same bf16 inputs. Rounding y to bf16 moves an element by at most
# 2⁻⁸·|y| (bf16's unit roundoff), and K12's rounding of h adds a spread of
# 1.6e-3·max|y| (the plain version in bf16, measured on the CPU), so:
# |err_i| ≤ GEMM_TOL_REL·|ref_i| + GEMM_TOL_FLOOR·max|ref| for every element
# (K10's plain version in bf16 stays below 1e-9·max|ref| past the first
# term, K12's at 0.40 of the floor); ‖err‖₂ ≤ GEMM_REL_L2_TOL·‖ref‖₂ (plain
# K10 1.66e-3, K12 2.33e-3; y × 1.005 gives 5e-3); and the mean signed error
# within GEMM_BIAS_TOL·rms(ref) (rounding to nearest has no bias: plain
# 4e-6 at 1032 × 128 outputs). The old bound, max|err| ≤ 2⁻⁷·max|ref|,
# passed y × 1.005.
GEMM_TOL_REL, GEMM_TOL_FLOOR, GEMM_REL_L2_TOL, GEMM_BIAS_TOL = 2 ** -8, 2 ** -8, 4e-3, 1e-4


def gemm_errors(y: torch.Tensor, ref: torch.Tensor) -> dict:
    """What ``gemm_gate`` reads of a GEMM's output ``y`` against its plain
    version's ``ref``."""
    r = ref.double()
    e = y.double() - r
    return {"excess": (e.abs() - GEMM_TOL_REL * r.abs()).max().item(), "max_err": e.abs().max().item(),
            "max_ref": r.abs().max().item(), "rel_l2": (e.norm() / r.norm()).item(),
            "mean_err": e.mean().item(), "rms_ref": r.square().mean().sqrt().item()}


def gemm_gate(stats: dict) -> tuple:
    """(pass, report) of the gate above on ``gemm_errors``' stats."""
    floor = GEMM_TOL_FLOOR * stats["max_ref"]
    bias_tol = GEMM_BIAS_TOL * stats["rms_ref"]
    ok = (stats["excess"] <= floor and stats["rel_l2"] <= GEMM_REL_L2_TOL
          and abs(stats["mean_err"]) <= bias_tol)
    return ok, (f"max|err| {stats['max_err']:.3e}, past 2^-8·|ref| {stats['excess']:.3e} (tol {floor:.3e}) "
                f"rel L2 {stats['rel_l2']:.3e} (tol {GEMM_REL_L2_TOL}) mean err {stats['mean_err']:.3e} "
                f"(tol {bias_tol:.3e})")


class GemmPlan(NamedTuple):
    """K10's launch plan for one product (``csrc/gemm_sm90.cu`` ``GemmCfg``)."""

    bn: int  # output columns of a tile (its rows: 128, two warpgroups of 64)
    stages: int  # 64-deep K steps in the TMA ring
    smem: int  # dynamic shared memory of a block, bytes
    threads: int  # of a block: two consumer warpgroups and the producer warp


_GEMM_BM, _GEMM_BK, _GEMM_SMEM_LIMIT = 128, 64, 232448


def gemm_plan(k: int, n: int, bn: Optional[int] = None) -> GemmPlan:
    """K10's plan for a product of depth ``k`` into ``n`` columns, from K and
    N alone, so that a row's bits do not depend on M; mirrors ``plan_bn``
    and ``GemmCfg`` in csrc/gemm_sm90.cu. The tile width (``bn`` asks for
    one of 112, 128, 160, 224, 256): at SDXL's shapes the fastest in the
    sweep of PERF.md (``kernel_times.py --sweep``), 160 for the forward's
    [·, 2560] → 640 and [·, 5120] → 1280, 112 and 224 for the dW products
    [·, 16384] → 640 and [·, 4096] → 1280 (120 and 240 tiles of 128 rows
    on 132 SMs); elsewhere 160 where it divides N, else 128. Stages: as
    many 64-deep steps of x [128, 64] and w [bn, 64] in bf16 (and their
    two mbarriers) as 227 KB hold after 1024 bytes of alignment slack, at
    most 8."""
    if bn is None:
        if n == 640:
            bn = 112 if k == 16384 else 160
        elif (n, k) == (1280, 4096):
            bn = 224
        else:
            bn = 160 if n % 160 == 0 else 128
    if bn not in (112, 128, 160, 224, 256):
        raise ValueError(f"K10 is built for tile widths 112, 128, 160, 224 and 256, not {bn}")
    stage = (_GEMM_BM + bn) * _GEMM_BK * 2
    stages = min(8, (_GEMM_SMEM_LIMIT - 1024) // (stage + 16))
    return GemmPlan(bn, stages, 1024 + stages * (stage + 16), 288)


def gemm_blocks(m: int, n: int, bn: int, sms: int) -> int:
    """Persistent blocks of K10: one per SM, or one per 128 × bn tile where
    there are fewer tiles; each walks the tiles ``blockIdx``, + grid, ..."""
    return min(-(-m // _GEMM_BM) * -(-n // bn), sms)


def _ffn_gemm(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, geglu: bool) -> torch.Tensor:
    name = "geglu_gemm" if geglu else "gemm"
    if x.device.type != "cuda":
        raise ValueError(f"the {name} kernel runs on CUDA tensors, got {x.device}")
    for label, t in (("x", x), ("w", w), ("bias", bias)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{'K12' if geglu else 'K10'} is built for bf16, got {label} {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16 or t.device != x.device:
            raise ValueError(f"{label} must be a contiguous, 16-byte aligned tensor on {x.device}")
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"the {name} kernel takes 2-D x and w, got {tuple(x.shape)} and {tuple(w.shape)}")
    (m, kx), (n, k) = x.shape, w.shape
    if kx != (2 * k if geglu else k) or bias.shape != (n,) or k % 64 or n % 2:
        raise ValueError(f"the {name} kernel needs x [M, {'2K' if geglu else 'K'}], w [N, K], bias [N] "
                         f"with K % 64 == 0 and N even, got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(bias.shape)}")
    out = torch.empty(m, n, device=x.device, dtype=x.dtype)
    args = (x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), m, n, k)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if geglu:
            err = kernels.library().fdt_geglu_gemm(*args, stream)
        else:
            err = kernels.library().fdt_gemm_sm90(*args, gemm_plan(k, n).bn, stream)
    kernels.check(err, name)
    LAUNCHES[name] += 1
    return out


def gemm(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K10: [M, N] = x [M, K] · w [N, K]ᵀ + bias [N]. CPU tensors take the
    plain version; CUDA tensors launch the kernel (bf16)."""
    if x.device.type == "cpu":
        return down_proj_gemm_reference(x, w, bias)
    return _ffn_gemm(x, w, bias, geglu=False)


def geglu_gemm(x2k: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K12: [M, N] = (a · gelu_tanh(g)) · w [N, K]ᵀ + bias [N] with
    x2k = [a | g] [M, 2K]. CPU tensors take the plain version; CUDA tensors
    launch the kernel (bf16)."""
    if x2k.device.type == "cpu":
        return geglu_down_proj_reference(x2k, w, bias)
    return _ffn_gemm(x2k, w, bias, geglu=True)


class DownProjGemmFunction(torch.autograd.Function):
    """K10 with the JAX ``_gemm_p`` custom VJP: dx = dy·W (a library
    product), dW = xᵀ·dy through K10 again when ``gemm_eligible(K, M, N)``
    holds, db = Σdy in fp32. dW and db only when asked (LoRA training
    freezes W)."""

    @staticmethod
    def forward(ctx, x2, w, bias):
        ctx.save_for_backward(x2, w)
        return gemm(x2, w, bias)

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        (m, k), n = x2.shape, dy.shape[1]
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = (dy @ w).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            if gemm_eligible(k, m, n):
                zeros = torch.zeros(n, dtype=dy.dtype, device=dy.device)
                dw = gemm(x2.t().contiguous(), dy.t().contiguous(), zeros).t().to(w.dtype)
            else:
                dw = (dy.t() @ x2).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = dy.float().sum(0).to(dy.dtype)
        return dx, dw, db


class GegluGemmFunction(torch.autograd.Function):
    """K12 with the JAX ``_geglu_p`` custom VJP, in plain PyTorch: dh = dy·W,
    h recomputed and dh taken back through the gate to dx2k, dW = hᵀ·dy,
    db = Σdy in fp32."""

    @staticmethod
    def forward(ctx, x2k, w, bias):
        ctx.save_for_backward(x2k, w)
        return geglu_gemm(x2k, w, bias)

    @staticmethod
    def backward(ctx, dy):
        x2k, w = ctx.saved_tensors
        with torch.enable_grad():
            x = x2k.detach().requires_grad_()
            h = geglu_h(x)
        dh = (dy @ w).to(h.dtype)
        (dx2k,) = torch.autograd.grad(h, x, dh)
        dw = (dy.t() @ h.detach()).to(w.dtype)
        db = dy.float().sum(0).to(dy.dtype)
        return dx2k, dw, db


def down_proj_gemm(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """y = x [..., K] · w [N, K]ᵀ (+ bias [N]): K10 for the shapes
    ``gemm_eligible`` takes when x's dtype is w's, else the unfused ops."""
    k, n = x.shape[-1], w.shape[0]
    m = x.numel() // k
    if gemm_eligible(m, k, n) and x.dtype == w.dtype:
        b = torch.zeros(n, dtype=x.dtype, device=x.device) if bias is None else bias.to(x.dtype)
        return DownProjGemmFunction.apply(x.reshape(m, k), w, b).reshape(*x.shape[:-1], n)
    y = F.linear(x, w)
    return y if bias is None else y + bias.to(y.dtype)


def geglu_down_proj(x2k: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """y = (a · gelu_tanh(g)) · w [N, K]ᵀ (+ bias [N]) with x2k = [a | g]
    [..., 2K]: K12 for bf16 calls that ``gemm_eligible`` takes, else the
    unfused ops."""
    n, k = w.shape
    m = x2k.numel() // (2 * k)
    if x2k.dtype == torch.bfloat16 and w.dtype == x2k.dtype and gemm_eligible(m, k, n):
        b = torch.zeros(n, dtype=x2k.dtype, device=x2k.device) if bias is None else bias.to(x2k.dtype)
        return GegluGemmFunction.apply(x2k.reshape(m, 2 * k), w, b).reshape(*x2k.shape[:-1], n)
    y = F.linear(geglu_h(x2k), w)
    return y if bias is None else y + bias.to(y.dtype)
