"""Attention ops: the hand-written flash-attention kernels and their plain versions.

Port of ``flash_diffusion_tpu/ops/attention.py`` (forward and backward).
``dot_product_attention`` keeps the JAX signature and layout ([B, S, H, D])
and semantics: ``scale`` defaults to 1/sqrt(D), an additive ``bias`` forces
the plain path (the causal CLIP mask), and ``kv_valid`` masks KV positions at
or beyond it to -1e30. Bias-free calls go to a kernel wrapper:

- on a CUDA tensor it launches a kernel or raises; it never falls back;
- on a CPU tensor it runs the plain PyTorch version of the same function.

Dispatch, as the JAX ``_attn_primal`` does it:

- ``flash_fwd_oneshot_packed`` (``csrc/attention_packed.cu``, the port of
  ``_flash_fwd_oneshot_packed_kernel``) through ``flash_attention_packed``
  on the projection-native [B, S, H·D] layout (a free reshape, no head
  transposes), for calls without ``kv_valid`` that ``packed_cross_eligible``
  takes: head dim 64 or 128, at least 2 heads, KV ≤ 256 once padded to
  128. At SDXL shapes: every cross-attention over the 77 text tokens. The
  JAX A/B switches of this path (``FLASH_TPU_ATTN_PACKED_CROSS``,
  ``_ANY_D``, ``FLASH_TPU_PACKED_CROSS_KV_MAX``) are TPU probes, not ported.
- ``flash_fwd_packed`` (``csrc/flash_fwd_packed.cu``, the port of
  ``_flash_fwd_packed_kernel``) through ``flash_attention_packed_stream``
  on the same layout, for every other call without ``kv_valid`` that
  ``packed_eligible`` takes: ``FLASH_TPU_ATTN_PACKED=1`` (read at call
  time, default ``"0"``, as in JAX), head dim 64 or 128, at least 2 heads.
  At SDXL shapes under the switch: the 4096- and 1024-token
  self-attention. One departure from JAX: its 1024-token call (padded KV ≤
  ``_ONESHOT_KV_MAX``) asks for the packed one-shot kernel, whose block
  its VMEM model rejects at H·D = 1280, and falls back to the per-head
  kernels; the port has no such limit and streams it here.
- every other call through ``flash_attention_bhsd`` on [B*H, S, D], which
  picks by ``attention_plan``:
  - ``flash_fwd_oneshot`` (``csrc/attention.cu``, the port of
    ``_flash_fwd_oneshot_kernel``): the whole padded KV of one (batch*head)
    in shared memory, whenever that tile set fits the 227 KB a block can
    have at a q tile of 64, 32 or 16 rows. At SD1.5 shapes: every
    cross-attention (KV = 77) and the 64- and 256-token self-attention
    (D = 160; 256 keys only at a 16-row q tile).
  - ``flash_fwd_stream`` (``csrc/flash_fwd_mma.cu``, the port of
    ``_flash_fwd_kernel``): online softmax over KV tiles with scores and
    accumulator in registers, for D <= 512. At SD1.5 and SDXL shapes: the
    1024- and 4096-token self-attention (without the switch) and the VAE's
    D = 512 mid-attention.

The JAX rule (padded KV <= 1024 is one-shot, ``attention.py:569``) does not
carry over: 1024 keys at D = 80 are 426 KB of K and V here.

Under a gradient (any of q, k, v requires grad) ``dot_product_attention``
goes through ``FlashAttention``, an autograd Function that mirrors the JAX
``_pallas_attention_vjp``: its forward is the [BH, S, D] path above (never
a packed kernel, switch or not) and saves q, k, v, out and lse as laid out
for the kernels; its backward is ``flash_attention_bwd_bhsd``, which picks by
``attention_bwd_plan``:

- ``flash_bwd_oneshot`` (``csrc/flash_bwd_oneshot.cu``, the port of
  ``_flash_bwd_oneshot_kernel``): the head's whole KV and fp32 dK/dV sums in
  one block's shared memory, whenever that fits at a q tile of 64 or 32
  rows. At SD1.5 shapes: every cross-attention (KV = 77) and the mid
  block's 64-token self-attention.
- ``flash_bwd_dkv`` then ``flash_bwd_dq`` (``csrc/flash_bwd.cu``, the ports
  of ``_flash_bwd_dkv_kernel`` and ``_flash_bwd_dq_kernel``): the
  streaming pair, for everything else; at SD1.5 shapes the 256-, 1024- and
  4096-token self-attention and the VAE's D = 512 mid-block.

The JAX route (``_use_oneshot_bwd``: a 14 MiB VMEM budget) does not carry
over to 227 KB of shared memory. Under ``torch.utils.checkpoint`` the
forward runs again in the backward, and its kernels count a launch again.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional, Tuple

import torch

from . import kernels

_NEG_INF = -1e30
_SMEM_LIMIT = 232448  # dynamic shared memory one H100 block can have
_WARPS = 4

# Launch counts of the kernels, raised by one per launch (never on the
# plain path). Reset them by assigning 0.
LAUNCHES = {
    "flash_fwd_oneshot": 0, "flash_fwd_stream": 0, "flash_fwd_oneshot_packed": 0, "flash_fwd_packed": 0,
    "flash_bwd_dkv": 0, "flash_bwd_dq": 0, "flash_bwd_oneshot": 0,
}
_STREAM_MAX_D = 512  # head dims the streaming kernel is built for
_PACKED_D = (64, 128)  # head dims the packed kernels are built for
_PACKED_KV_MAX = 256  # the JAX default of FLASH_TPU_PACKED_CROSS_KV_MAX
_PACKED_BQ = 64  # q rows of one packed block


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _align128(n: int) -> int:
    return _round_up(n, 128)


def smem_bytes(bq: int, kvp: int, dp: int) -> int:
    """Shared memory of one block of the one-shot kernel; mirrors ``Layout``
    in csrc/attention.cu."""
    ld_qkv, ld_s, ld_p = dp + 8, kvp + 4, kvp + 8
    total = _align128(bq * ld_qkv * 2) + 2 * _align128(kvp * ld_qkv * 2)
    total += _align128(bq * ld_s * 4) + _align128(bq * ld_p * 2)
    total += _align128(_WARPS * 16 * 16 * 4)
    return total + 2 * _align128(bq * 4)


def attention_plan(kv_len: int, d: int) -> Tuple[str, int]:
    """(kernel, q tile rows) for ``kv_len`` valid keys at head dim ``d``.

    The one-shot kernel takes a q tile of 64, 32 or 16 rows, the largest
    whose tile set fits; the streaming kernel has fixed tiles."""
    dp, kvp = _round_up(d, 16), _round_up(kv_len, 16)
    for bq in (64, 32, 16):
        if smem_bytes(bq, kvp, dp) <= _SMEM_LIMIT:
            return "flash_fwd_oneshot", bq
    if d <= _STREAM_MAX_D:
        return "flash_fwd_stream", 64
    raise ValueError(f"head dim {d} too large for the attention kernels")


def attention_bhsd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    kv_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernels: fp32 softmax over q·kᵀ·scale.

    Returns (out [BH, Sq, D] in q's dtype, lse [BH, Sq] fp32; fp64 for
    fp64 inputs)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bqd,bkd->bqk", q.to(acc), k.to(acc)) * scale
    if kv_valid is not None and kv_valid < k.shape[1]:
        s[..., kv_valid:] = _NEG_INF
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", p, v.to(acc)) / l
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _check_cuda_inputs(q, k, v, kv_len):
    if q.device.type != "cuda":
        raise ValueError(f"the attention kernels run on CUDA tensors, got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the attention kernels take bf16, got {name} {t.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [BH, S, D] tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    bh, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d % 8:
        raise ValueError(f"head dim {d} must be a multiple of 8")
    if not 1 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_valid {kv_len} outside [1, {k.shape[1]}]")
    if bh > 65535:
        raise ValueError(f"B*H = {bh} exceeds the grid's y limit")


def flash_attention_bhsd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    kv_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash forward over [BH, S, D]: (out [BH, Sq, D], lse [BH, Sq] fp32).

    CPU tensors take the plain version; CUDA tensors launch a kernel."""
    if q.device.type == "cpu":
        return attention_bhsd_reference(q, k, v, scale, kv_valid)
    kv_len = k.shape[1] if kv_valid is None else kv_valid
    _check_cuda_inputs(q, k, v, kv_len)
    bh, sq, d = q.shape
    kind, bq = attention_plan(kv_len, d)
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    lib = kernels.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            bh, sq, k.shape[1], d, kv_len, float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kind == "flash_fwd_oneshot":
            err = lib.fdt_flash_fwd_oneshot(*args, bq, _round_up(kv_len, 16), stream)
        else:
            err = lib.fdt_flash_fwd_stream_mma(*args, stream)
    kernels.check(err, kind)
    LAUNCHES[kind] += 1
    return out, lse


def packed_cross_eligible(q4: torch.Tensor, kv_len: int) -> bool:
    """Whether a [B, Sq, H, D] call over ``kv_len`` keys takes the packed
    kernel: the JAX ``_packed_cross_eligible`` at its defaults."""
    _, _, h, d = q4.shape
    return h >= 2 and d in _PACKED_D and _align128(kv_len) <= _PACKED_KV_MAX


def packed_smem_bytes(d: int, kvp: int) -> int:
    """Shared memory of one packed block (64 q rows and the padded KV of one
    head); mirrors csrc/attention_packed.cu."""
    return (_PACKED_BQ + 2 * kvp) * (d + 8) * 2


def attention_packed_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float,
) -> torch.Tensor:
    """Plain version of the packed kernel on [B, S, H·D]: per head, fp32
    softmax over q·kᵀ·scale, p cast to v's dtype before p·v, divided by the
    fp32 row sum. Returns [B, Sq, H·D] in q's dtype."""
    b, sq, hd = q.shape
    d = hd // num_heads
    heads = lambda x: x.reshape(b, x.shape[1], num_heads, d).float()
    s = torch.einsum("bqhd,bkhd->bhqk", heads(q), heads(k)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1).transpose(1, 2)[..., None]  # [B, Sq, H, 1]
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), heads(v)) / l
    return out.reshape(b, sq, hd).to(q.dtype)


def _check_packed_inputs(q, k, v, num_heads):
    if q.device.type != "cuda":
        raise ValueError(f"the attention kernels run on CUDA tensors, got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the attention kernels take bf16, got {name} {t.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [B, S, H*D] tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, _, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if num_heads < 1 or hd % num_heads or hd // num_heads not in _PACKED_D:
        raise ValueError(f"the packed kernel takes head dims {_PACKED_D}, got {hd} / {num_heads} heads")
    if not 1 <= b <= 65535:
        raise ValueError(f"batch {b} outside the grid's z range")


def _launch_packed(name, q, k, v, num_heads, scale):
    """Launches the packed kernel ``name`` on checked CUDA inputs."""
    b, sq, hd = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = getattr(kernels.library(), f"fdt_{name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, k.shape[1],
            num_heads, hd // num_heads, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
        )
    kernels.check(err, name)
    LAUNCHES[name] += 1
    return out


def flash_attention_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float,
) -> torch.Tensor:
    """Packed one-shot forward: q [B, Sq, H·D], k/v [B, KV, H·D] → [B, Sq, H·D].

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return attention_packed_reference(q, k, v, num_heads, scale)
    _check_packed_inputs(q, k, v, num_heads)
    if packed_smem_bytes(q.shape[2] // num_heads, _round_up(k.shape[1], 16)) > _SMEM_LIMIT:
        raise ValueError(f"KV {k.shape[1]} does not fit the packed kernel's shared memory")
    return _launch_packed("flash_fwd_oneshot_packed", q, k, v, num_heads, scale)


def packed_eligible(q4: torch.Tensor) -> bool:
    """Whether a [B, Sq, H, D] call without ``kv_valid`` takes the packed
    streaming kernel: the JAX ``_packed_eligible`` (``FLASH_TPU_ATTN_PACKED``
    read at call time, off by default; its ``_ANY_D`` probe not ported)."""
    _, _, h, d = q4.shape
    return os.environ.get("FLASH_TPU_ATTN_PACKED", "0") == "1" and h >= 2 and d in _PACKED_D


def flash_attention_packed_stream(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float,
) -> torch.Tensor:
    """Packed streaming forward: q [B, Sq, H·D], k/v [B, KV, H·D] → [B, Sq, H·D],
    any KV. The function is that of ``flash_attention_packed``, so both
    share the plain version.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return attention_packed_reference(q, k, v, num_heads, scale)
    _check_packed_inputs(q, k, v, num_heads)
    return _launch_packed("flash_fwd_packed", q, k, v, num_heads, scale)


_BWD_WARPS = 8  # warps of one backward block (csrc/bwd_tiles.cuh kWarps)
_BWD_SCRATCH = _BWD_WARPS * 16 * 16 * 4  # the one-shot kernel's dq staging tiles
_BWD_BLOCKS_PER_SM = 2  # one-shot blocks to aim for


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bwd_smem_bytes(bq: int, bkv: int, dp: int, acc_rows: int, dc: int, n_acc: int,
                   scratch: int = 0) -> int:
    """Shared memory of one backward block; mirrors ``BwdLayout`` in
    csrc/bwd_tiles.cuh."""
    ld_x, ld_s, ld_p = dp + 8, bkv + 4, bkv + 8
    total = 2 * _align128(bq * ld_x * 2) + 2 * _align128(bkv * ld_x * 2) + 2 * _align128(bq * 4)
    total += 2 * _align128(bq * ld_s * 4) + 2 * _align128(bq * ld_p * 2)
    return total + n_acc * _align128(acc_rows * dc * 4) + _align128(scratch)


def attention_bwd_plan(kv_len: int, d: int) -> Tuple[str, int, int, int]:
    """(route, q tile rows, kv tile rows, output column chunk) of the
    backward for ``kv_len`` valid keys at head dim ``d``.

    ``flash_bwd_oneshot`` when the head's padded KV, its fp32 dK and dV and a
    q tile of 64 or 32 rows fit one block (kv tile = the padded KV, columns
    whole); else the ``flash_bwd_pair`` K6 + K7 with square tiles of 64, 32
    or 16 rows and the widest column chunk (a divisor of the padded D) whose
    layout fits."""
    dp, kvp = _round_up(d, 16), _round_up(kv_len, 16)
    for bq in (64, 32):
        if bwd_smem_bytes(bq, kvp, dp, kvp, dp, 2, _BWD_SCRATCH) <= _SMEM_LIMIT:
            return "flash_bwd_oneshot", bq, kvp, dp
    chunks = [dp] + [c for c in (256, 128, 64, 32, 16) if c < dp and dp % c == 0]
    for b in (64, 32, 16):
        for dc in chunks:
            if bwd_smem_bytes(b, b, dp, b, dc, 2) <= _SMEM_LIMIT:  # K6's; K7 holds one accumulator
                return "flash_bwd_pair", b, b, dc
    raise ValueError(f"head dim {d} too large for the attention backward kernels")


def attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, scale: float, kv_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels, with their rounding points:
    p = exp(s·scale − lse) and Δ = rowsum(dO∘O) in fp32 (fp64 for fp64
    inputs), dv = pᵀ·dO and dk = dsᵀ·q·scale and dq = ds·k·scale with p and
    ds = p∘(dO·vᵀ − Δ) rounded to q's dtype first; keys ≥ ``kv_valid`` get
    −1e30. Returns (dq, dk, dv) in the inputs' dtypes."""
    acc = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, dof = (t.to(acc) for t in (q, k, v, do))
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    if kv_valid is not None and kv_valid < k.shape[1]:
        s[..., kv_valid:] = _NEG_INF
    p = torch.exp(s - lse.to(acc)[..., None])
    delta = (dof * o.to(acc)).sum(-1)
    dv = torch.einsum("bqk,bqd->bkd", p.to(q.dtype).to(acc), dof)
    ds = p * (torch.einsum("bqd,bkd->bqk", dof, vf) - delta[..., None])
    ds = ds.to(q.dtype).to(acc)
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_bhsd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, scale: float, kv_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash backward over [BH, S, D]: (dq, dk, dv) from the forward's
    inputs, its out and lse, and the cotangent ``do`` of out.

    CPU tensors take the plain version; CUDA tensors launch K8, or K6 then
    K7, as ``attention_bwd_plan`` says."""
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, o, lse, do, scale, kv_valid)
    kv_len = k.shape[1] if kv_valid is None else kv_valid
    _check_cuda_inputs(q, k, v, kv_len)
    bh, sq, d = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous bf16 [BH, Sq, D] tensor on {q.device}")
    if lse.shape != (bh, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous fp32 [BH, Sq] tensor")
    delta = (do.float() * o.float()).sum(-1)  # Δ: a plain reduction, as in JAX (XLA there)
    route, bq, bkv, dc = attention_bwd_plan(kv_len, d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = kernels.library()
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    dims = (bh, sq, k.shape[1], d, kv_len, float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "flash_bwd_oneshot":
            q_tiles = -(-sq // bq)
            target = _BWD_BLOCKS_PER_SM * _sm_count(q.device.index)
            per_split = -(-q_tiles // max(1, min(q_tiles, -(-target // bh))))
            nsplit = -(-q_tiles // per_split)
            ws = torch.empty(2 * nsplit * bh * bkv * dc, dtype=torch.float32, device=q.device)
            err = lib.fdt_flash_bwd_oneshot(*ins, dq.data_ptr(), ws.data_ptr(), dk.data_ptr(),
                                            dv.data_ptr(), *dims, bq, bkv, nsplit, per_split, stream)
            kernels.check(err, route)
            LAUNCHES[route] += 1
        else:
            err = lib.fdt_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *dims, bq, bkv, dc, stream)
            kernels.check(err, "flash_bwd_dkv")
            LAUNCHES["flash_bwd_dkv"] += 1
            err = lib.fdt_flash_bwd_dq(*ins, dq.data_ptr(), *dims, bq, bkv, dc, stream)
            kernels.check(err, "flash_bwd_dq")
            LAUNCHES["flash_bwd_dq"] += 1
    return dq, dk, dv


def reference_attention(q, k, v, bias=None, scale=1.0, kv_valid=None):
    """Plain [B, S, H, D] attention (fp32 softmax), as the JAX ``_xla_attention``.

    Used for biased calls (the causal CLIP mask)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if kv_valid is not None and kv_valid < k.shape[1]:
        s[..., kv_valid:] = _NEG_INF
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _to_bhsd(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    # at b == 1 the reshape is a strided view, not a copy
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _from_bhsd(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2)


class FlashAttention(torch.autograd.Function):
    """[B, S, H, D] attention with the flash backward (the JAX
    ``_pallas_attention_vjp``): the forward saves the [BH, S, D] tensors it
    made and the lse, so that the backward relays nothing out again."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, kv_valid: Optional[int]):
        b, _, h, _ = q.shape
        qt, kt, vt = _to_bhsd(q), _to_bhsd(k), _to_bhsd(v)
        out, lse = flash_attention_bhsd(qt, kt, vt, scale, kv_valid)
        ctx.save_for_backward(qt, kt, vt, out, lse)
        ctx.scale, ctx.kv_valid, ctx.heads = scale, kv_valid, h
        return _from_bhsd(out, b, h)

    @staticmethod
    def backward(ctx, g):
        qt, kt, vt, out, lse = ctx.saved_tensors
        b, h = g.shape[0], ctx.heads
        dq, dk, dv = flash_attention_bwd_bhsd(qt, kt, vt, out, lse, _to_bhsd(g), ctx.scale, ctx.kv_valid)
        return _from_bhsd(dq, b, h), _from_bhsd(dk, b, h), _from_bhsd(dv, b, h), None, None


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    kv_valid: Optional[int] = None,
) -> torch.Tensor:
    """Multi-head attention. q: [B, Sq, H, D]; k/v: [B, Skv, H, D] → [B, Sq, H, D].

    ``bias`` (broadcastable to [B, H, Sq, Skv]) takes the plain path; under a
    gradient every other call goes through ``FlashAttention``; without one,
    calls without ``kv_valid`` that ``packed_cross_eligible`` takes go to
    ``flash_attention_packed``, those that ``packed_eligible`` takes to
    ``flash_attention_packed_stream``, and every other call to
    ``flash_attention_bhsd``."""
    b, sq, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if kv_valid is not None and kv_valid >= k.shape[1]:
        kv_valid = None
    if bias is not None:
        return reference_attention(q, k, v, bias, scale, kv_valid)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale, kv_valid)
    if kv_valid is None:
        packed = lambda x: x.reshape(b, x.shape[1], h * d).contiguous()  # free for projections
        if packed_cross_eligible(q, k.shape[1]):
            return flash_attention_packed(packed(q), packed(k), packed(v), h, scale).reshape(b, sq, h, d)
        if packed_eligible(q):
            return flash_attention_packed_stream(packed(q), packed(k), packed(v), h, scale).reshape(b, sq, h, d)
    out, _ = flash_attention_bhsd(_to_bhsd(q), _to_bhsd(k), _to_bhsd(v), scale, kv_valid)
    return _from_bhsd(out, b, h)
