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
    in shared memory, for head dims up to 160, whenever it and a q tile of
    64, 32 or 16 rows fit the 227 KB a block can have. At SD1.5 shapes:
    every cross-attention (KV = 77) and the 64- and 256-token
    self-attention (D = 160).
  - ``flash_fwd_stream``, the port of ``_flash_fwd_kernel``: online
    softmax over KV tiles, for D <= 512, on one of two kernels by
    ``stream_fwd_tiles``: ``csrc/flash_fwd_wgmma.cu`` up to D = 128 (wgmma
    fed by a TMA ring, two consumer warpgroups in ping-pong) and
    ``csrc/flash_fwd_mma.cu`` above (mma.sync, the VAE's D = 512). At
    SD1.5, SDXL and Pixart shapes: the 1024- and 4096-token self-attention
    (without the switch) and the VAE's D = 512 mid-attention.

The JAX rule (padded KV <= 1024 is one-shot, ``attention.py:569``) does not
carry over: 1024 keys at D = 80 are 426 KB of K and V here.

Under a gradient (any of q, k, v requires grad) ``dot_product_attention``
goes through ``FlashAttention``, an autograd Function that mirrors the JAX
``_pallas_attention_vjp``: its forward is the [BH, S, D] path above (never
a packed kernel, switch or not) and saves q, k, v, out and lse as laid out
for the kernels; its backward is ``flash_attention_bwd_bhsd``, which picks by
``attention_bwd_plan``:

- ``flash_bwd_oneshot`` (``csrc/flash_bwd_oneshot.cu``, the port of
  ``_flash_bwd_oneshot_kernel``): the head's whole KV in one block, its
  dK/dV sums in registers, for head dims up to 160 and up to 128 padded
  keys (80 above D = 80). At SD1.5 shapes: every cross-attention (KV = 77)
  and the mid block's 64-token self-attention.
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
from typing import NamedTuple, Optional, Tuple

import torch

from . import kernels

_NEG_INF = -1e30
_SMEM_LIMIT = 232448  # dynamic shared memory one H100 block can have

# Launch counts of the kernels, raised by one per launch (never on the
# plain path). Reset them by assigning 0.
LAUNCHES = {
    "flash_fwd_oneshot": 0, "flash_fwd_stream": 0, "flash_fwd_oneshot_packed": 0, "flash_fwd_packed": 0,
    "flash_bwd_dkv": 0, "flash_bwd_dq": 0, "flash_bwd_oneshot": 0,
}
_STREAM_MAX_D = 512  # head dims the streaming kernel is built for
_ONESHOT_MAX_D = 160  # and the one-shot kernel
_PACKED_D = (64, 128)  # head dims the packed kernels are built for
_PACKED_KV_MAX = 256  # the JAX default of FLASH_TPU_PACKED_CROSS_KV_MAX
_PACKED_BQ = 64  # q rows of one packed block


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _align128(n: int) -> int:
    return _round_up(n, 128)


def smem_bytes(bq: int, kvp: int, dp: int) -> int:
    """Shared memory of one block of the one-shot kernel: Q [bq, dp], K and V
    [kvp, dp] in bf16, row stride dp + 8; mirrors ``smem_bytes`` in
    csrc/attention.cu."""
    return (bq + 2 * kvp) * (dp + 8) * 2


class StreamTiles(NamedTuple):
    """The streaming forward's tiles at one head dim."""

    route: str  # "wgmma" (csrc/flash_fwd_wgmma.cu, D ≤ 128) or "mma" (csrc/flash_fwd_mma.cu, above)
    dp: int  # padded head dim
    bq: int  # q rows of a block
    bkv: int  # keys of a streamed K/V tile
    stages: int  # K/V tiles in flight (the ring)
    threads: int  # of a block
    smem: int  # dynamic shared memory of a block, bytes


_STREAM_WGMMA_MAX_D = 128


def stream_fwd_tiles(d: int) -> StreamTiles:
    """The streaming forward's tiles at head dim ``d`` (d % 8 == 0, d ≤ 512);
    never from Sq, KV or BH, so a head's output does not depend on the
    batch. Up to D = 128 the wgmma kernel (mirrors ``FwdCfg`` in
    csrc/flash_fwd_wgmma.cu): D padded to a multiple of 16, 128 q rows (two
    consumer warpgroups and a producer warpgroup), 128-key tiles up to D =
    80 and 64 above (shared memory), four stages; shared memory Q [128, dp]
    and four stages of K and V [bkv, dp] in bf16, nine 8-byte mbarriers. Above, the mma.sync
    kernel (``Tiles`` in csrc/flash_fwd_mma.cu): D padded to 144 or 160, or
    a multiple of 64; 64 q rows, two warps a row group above D = 160, KV
    tiles of 64 keys (32 above 160) double-buffered at row stride dp + 8."""
    if d % 8 or not 8 <= d <= _STREAM_MAX_D:
        raise ValueError(f"head dim {d} outside the streaming forward's (a multiple of 8 up to 512)")
    if d <= _STREAM_WGMMA_MAX_D:
        dp = _round_up(d, 16)
        bkv, stages = (128 if dp <= 80 else 64), 4
        smem = 128 * dp * 2 + stages * 2 * bkv * dp * 2 + (1 + 2 * stages) * 8
        return StreamTiles("wgmma", dp, 128, bkv, stages, 384, smem)
    dp = _round_up(d, 16) if d <= 160 else _round_up(d, 64)
    bkv, warps_d = (64, 1) if dp <= 160 else (32, 2)
    return StreamTiles("mma", dp, 64, bkv, 2, 128 * warps_d, (64 + 4 * bkv) * (dp + 8) * 2)


def attention_plan(kv_len: int, d: int) -> Tuple[str, int]:
    """(kernel, q tile rows) for ``kv_len`` valid keys at head dim ``d``.

    The one-shot kernel takes head dims up to 160 and the largest q tile of
    64, 32 or 16 rows at which the head's padded K and V and the tile fit a
    block; the streaming kernel's tiles follow D alone (``stream_fwd_tiles``)."""
    dp, kvp = _round_up(d, 16), _round_up(kv_len, 16)
    if d <= _ONESHOT_MAX_D:
        for bq in (64, 32, 16):
            if smem_bytes(bq, kvp, dp) <= _SMEM_LIMIT:
                return "flash_fwd_oneshot", bq
    if d <= _STREAM_MAX_D:
        return "flash_fwd_stream", stream_fwd_tiles(_round_up(d, 8)).bq
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


# The gate of the one-shot forward kernel against the plain version in fp32
# on the same bf16 inputs: max|out err| ≤ FWD_TOL_FLOOR + FWD_TOL_REL·max|ref|
# (the output's own rounding is 2⁻⁹ of |out|), the mean signed error within
# FWD_BIAS_TOL (rounding to nearest has no bias; a key that leaks into the
# softmax pulls every row of a v + 1 case the same way), and max|lse err| ≤
# FWD_LSE_TOL. A typical |out| is 0.03–0.3, so an absolute 2e-2 would pass a
# kernel off by several percent or one that leaks masked keys.
FWD_TOL_FLOOR, FWD_TOL_REL, FWD_BIAS_TOL, FWD_LSE_TOL = 4e-3, 2 ** -8, 5e-4, 5e-3


def attention_fwd_errors(out, lse, ref_out, ref_lse) -> dict:
    """What ``attention_fwd_gate`` reads of (out, lse) against the plain
    version's (ref_out, ref_lse)."""
    e = out.double() - ref_out.double()
    return {"max_err": e.abs().max().item(), "max_ref": ref_out.abs().max().item(),
            "mean_err": e.mean().item(), "lse_err": (lse.double() - ref_lse.double()).abs().max().item()}


def attention_fwd_gate(stats: dict) -> Tuple[bool, str]:
    """(pass, report) of the gate above on ``attention_fwd_errors``' stats."""
    tol = FWD_TOL_FLOOR + FWD_TOL_REL * stats["max_ref"]
    ok = stats["max_err"] <= tol and abs(stats["mean_err"]) <= FWD_BIAS_TOL and stats["lse_err"] <= FWD_LSE_TOL
    return ok, (f"max|out err| {stats['max_err']:.3e} (tol {tol:.3e}) mean err {stats['mean_err']:.3e} "
                f"(tol {FWD_BIAS_TOL}) max|lse err| {stats['lse_err']:.3e} (tol {FWD_LSE_TOL})")


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
            err = lib.fdt_flash_fwd_oneshot(*args, bq, stream)
        elif stream_fwd_tiles(d).route == "wgmma":
            err = lib.fdt_flash_fwd_stream_wgmma(*args, stream)
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


_BWD_MIN_ROWS = 128  # q rows of a K8 split, at least: its partial dK, dV stay a fraction of its q traffic


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class OneshotTiles(NamedTuple):
    """K8's tiles for one head."""

    kvp: int  # keys, padded to a multiple of 16: the rows of K and V in the block
    dp: int  # padded head dim
    bs: int  # q rows of a streamed tile
    threads: int  # of a block: 32 a warp, one warp (two above D = 80) on each 16-row kv band
    smem: int  # dynamic shared memory of a block, bytes


def bwd_smem_bytes(kvp: int, dp: int) -> int:
    """Shared memory of one K8 block: K and V [kvp, dp] bf16, two stages of
    (q, dO, o [bs, dp] bf16; lse, Δ [bs] fp32), dSᵀ [kvp, bs] bf16, at row
    strides dp + 8 and bs + 8; mirrors ``smem_bytes`` in
    csrc/flash_bwd_oneshot.cu."""
    bs = _bwd_q_tile_rows(dp)
    stage = 3 * bs * (dp + 8) * 2 + 2 * bs * 4
    return 2 * kvp * (dp + 8) * 2 + 2 * stage + kvp * (bs + 8) * 2


def _bwd_q_tile_rows(dp: int) -> int:
    """q rows of K8's streamed tile: 32, or 16 at padded D = 160 (registers)."""
    return 16 if dp > 128 else 32


def bwd_oneshot_tiles(kv_len: int, d: int) -> Optional[OneshotTiles]:
    """K8's tiles for ``kv_len`` valid keys at head dim ``d``, or None where
    K8 does not take the head: D up to 160 (padded to a multiple of 16 up to
    80, else to 96, 128 or 160) and at most 128 padded keys up to D = 80
    (8 warps), 80 above (10 warps: two a band, each on half the columns);
    mirrors ``fdt_flash_bwd_oneshot_tiles``."""
    if d % 8 or not 8 <= d <= _ONESHOT_MAX_D:
        return None
    dp = _round_up(d, 16) if d <= 80 else 96 if d <= 96 else 128 if d <= 128 else 160
    kvp, wb = _round_up(kv_len, 16), 1 if dp <= 80 else 2
    if kvp > (128 if wb == 1 else 80):
        return None
    return OneshotTiles(kvp, dp, _bwd_q_tile_rows(dp), kvp // 16 * wb * 32, bwd_smem_bytes(kvp, dp))


def bwd_splits(sq: int, bs: int, sms: int) -> Tuple[int, int]:
    """(nsplit, q tiles a split) of K8 over ``sq`` query rows in tiles of
    ``bs`` rows on a card of ``sms`` SMs: at most sms / 8 splits of at least
    ``_BWD_MIN_ROWS`` rows. Never from BH, so a head's dK and dV are summed
    in one order alone and in any batch."""
    q_tiles = -(-sq // bs)
    per_split = max(_BWD_MIN_ROWS // bs, -(-q_tiles // max(1, sms // 8)))
    return -(-q_tiles // per_split), per_split


class PairTiles(NamedTuple):
    """The tiles of one kernel of the streaming pair (K6 or K7)."""

    dp: int  # padded head dim
    rows: int  # resident rows of a block: K6 kv rows, K7 q rows
    stream: int  # rows of a streamed tile: K6 q rows, K7 kv rows
    dc: int  # output columns of a block (grid z = dp // dc)
    wb: int  # warps on one 16-row band, each with dc // wb of its output columns
    wgmma: int  # 1: wgmma, two warpgroups of 64 rows; 0: mma.sync, four warps
    smem: int  # dynamic shared memory of a block, bytes


def bwd_pair_tiles(d: int) -> Tuple[PairTiles, PairTiles]:
    """K6's and K7's tiles at head dim ``d`` (d % 8 == 0, d ≤ 512); mirrors
    ``pair_dp`` and ``PairCfg`` in csrc/flash_bwd.cu: D padded to a multiple
    of 16 up to 128, to 160 up to 160, to a multiple of 64 above; the tiles
    that keep each kernel's register accumulators unspilled; wgmma with 8
    warps up to D = 128, mma.sync with 4 above. Shared memory: two resident
    [rows, dp] bf16 tiles, two stages of two streamed [stream, dp] tiles,
    K6's fp32 lse and Δ of each stage's q rows, two 8-byte mbarriers."""
    if d % 8 or not 8 <= d <= _STREAM_MAX_D:
        raise ValueError(f"head dim {d} outside the attention backward kernels' (a multiple of 8 up to 512)")
    dp = _round_up(d, 16) if d <= 128 else 160 if d <= 160 else _round_up(d, 64)
    k6 = (1 if dp <= 128 else 2, 64 if dp <= 96 or dp == 160 else 32, dp if dp <= 160 else dp // 2, 8)
    k7 = (1 if dp <= 160 else 2, 64 if dp <= 128 else 32, dp, 0)
    warps, tiles = 8 if dp <= 128 else 4, []
    for wb, stream, dc, stat_bytes_per_row in (k6, k7):
        rows = 16 * warps // wb
        stage = 2 * stream * dp * 2 + stream * stat_bytes_per_row
        tiles.append(PairTiles(dp, rows, stream, dc, wb, int(dp <= 128), 2 * rows * dp * 2 + 2 * stage + 16))
    return tiles[0], tiles[1]


def attention_bwd_plan(kv_len: int, d: int) -> Tuple[str, tuple]:
    """(route, tiles) of the backward for ``kv_len`` valid keys at head dim ``d``.

    ``flash_bwd_oneshot`` with ``bwd_oneshot_tiles`` where K8 takes the head
    (the whole padded KV in one block); else the ``flash_bwd_pair`` K6 + K7
    with ``bwd_pair_tiles(d)``."""
    tiles = bwd_oneshot_tiles(kv_len, d)
    if tiles is not None:
        return "flash_bwd_oneshot", tiles
    return "flash_bwd_pair", bwd_pair_tiles(d)


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


# The gate of the backward kernels against the plain version in fp32 on the
# same bf16 inputs, for each of dq, dk, dv: max|err| ≤ BWD_TOL_FLOOR +
# BWD_TOL_REL·max|ref| and ‖err‖₂ ≤ BWD_REL_L2_TOL·‖ref‖₂; and the dk, dv rows
# at or past ``kv_valid`` exactly 0. At unit-normal inputs a gradient's rms
# is ≈ 0.03 and its max ≈ 0.3, so an absolute 2e-2 (the forward's) would
# pass a kernel off by several percent or one that leaks masked keys.
BWD_TOL_FLOOR, BWD_TOL_REL, BWD_REL_L2_TOL = 4e-3, 2 ** -6, 1e-2


def attention_bwd_errors(got, want, kv_valid: Optional[int] = None) -> list:
    """What ``attention_bwd_gate`` reads, for each of (dq, dk, dv) of ``got``
    against ``want``: max|err|, max|ref|, Σerr², Σref² and the non-zero
    entries of dk, dv at rows ≥ ``kv_valid``. Stats of slices of the batch
    add up with ``merge_bwd_errors``."""
    stats = []
    for i, (g, w) in enumerate(zip(got, want)):
        e = g.double() - w.double()
        tail = g[:, kv_valid:] if i and kv_valid is not None else g[:, :0]
        stats.append({"max_err": e.abs().max().item(), "max_ref": w.abs().max().item(),
                      "sq_err": (e * e).sum().item(), "sq_ref": w.double().square().sum().item(),
                      "tail_nonzero": int(torch.count_nonzero(tail))})
    return stats


def merge_bwd_errors(a: list, b: list) -> list:
    return [{k: max(x[k], y[k]) if k.startswith("max") else x[k] + y[k] for k in x} for x, y in zip(a, b)]


def attention_bwd_gate(stats: list) -> Tuple[bool, str]:
    """(pass, report) of the gate above on ``attention_bwd_errors``' stats."""
    ok, parts = True, []
    for name, s in zip(("dq", "dk", "dv"), stats):
        tol = BWD_TOL_FLOOR + BWD_TOL_REL * s["max_ref"]
        rel = math.sqrt(s["sq_err"] / s["sq_ref"]) if s["sq_ref"] else math.sqrt(s["sq_err"])
        ok &= s["max_err"] <= tol and rel <= BWD_REL_L2_TOL and s["tail_nonzero"] == 0
        parts.append(f"{name} max|err| {s['max_err']:.3e} (tol {tol:.3e}) rel L2 {rel:.3e}"
                     + (f" tail≠0 {s['tail_nonzero']}" if name != "dq" else ""))
    return ok, "; ".join(parts) + f" (rel L2 tol {BWD_REL_L2_TOL})"


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
        if (t.shape != q.shape or t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != q.device
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned bf16 [BH, Sq, D] tensor on {q.device}")
    if lse.shape != (bh, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous fp32 [BH, Sq] tensor")
    route, tiles = attention_bwd_plan(kv_len, d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = kernels.library()
    dims = (bh, sq, k.shape[1], d, kv_len, float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "flash_bwd_oneshot":  # K8 computes Δ = rowsum(dO∘O) itself
            nsplit, per_split = bwd_splits(sq, tiles.bs, _sm_count(q.device.index))
            ws = torch.empty(2 * nsplit * bh * tiles.kvp * tiles.dp if nsplit > 1 else 0, dtype=torch.float32,
                             device=q.device)
            ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), o.data_ptr())
            err = lib.fdt_flash_bwd_oneshot(*ins, dq.data_ptr(), ws.data_ptr(), dk.data_ptr(),
                                            dv.data_ptr(), *dims, nsplit, per_split, stream)
            kernels.check(err, route)
            LAUNCHES[route] += 1
        else:
            delta = (do.float() * o.float()).sum(-1)  # Δ: a plain reduction, as in JAX (XLA there)
            ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr())
            err = lib.fdt_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *dims, stream)
            kernels.check(err, "flash_bwd_dkv")
            LAUNCHES["flash_bwd_dkv"] += 1
            err = lib.fdt_flash_bwd_dq(*ins, dq.data_ptr(), *dims, stream)
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
