"""Shared neural building blocks of the PyTorch port.

Port of ``flash_diffusion_tpu/models/layers.py``. Modules carry diffusers
state-dict names, so a port ``state_dict()`` goes through the JAX package's
``utils/hf.py`` importers unchanged. Convolutions run channel-first (NCHW);
token sequences are [B, S, C] with S in h-major order, the order of the JAX
package's ``reshape(b, h*w, c)`` of NHWC. Attention goes through
``ops.dot_product_attention`` (the flash kernels; a biased call takes the
plain path), LayerNorm through ``ops.layer_norm`` (the LayerNorm kernel),
GroupNorm through ``ops.group_norm`` (the GroupNorm kernels, with the JAX
numerics). The projections the JAX package builds as
``LoraDense`` (attention ``to_q``/``to_k``/``to_v``/``to_out.0``, the
GEGLU feed-forward's two, and the spatial transformers' ``proj_in``/
``proj_out``, SD1.5's 1×1 convs included) go through ``lora_dense``, which
adds the LoRA side path ``(x·A)·B`` when a factor pair is attached to the
layer (``lora.attach_lora``), and takes the W8A8 int8 branch of the JAX
``LoraDense`` (``flash_diffusion_tpu/models/layers.py:90-104``) when the
layer's weight is int8 (``quant.quantize_dense``): the product on the int8
GEMM kernel, then the side path, then the bias in the output dtype.

The GEGLU feed-forward reads the JAX package's two opt-in switches at call
time (default ``"0"``, as there; ``layers.py:458-476``):
``FLASH_TPU_FFN_FUSED=1`` sends a bf16 up-projection output straight to
``ops.geglu_down_proj`` (K12) with ``proj_out``'s weight (an int8 one
dequantized in fp32, then cast), and ``FLASH_TPU_FFN_DOWN_GEMM=1`` sends
the gated product of a float ``proj_out`` to ``ops.down_proj_gemm`` (K10).
Both add a LoRA pair of ``proj_out`` after the product, bias included.

The convolutions the JAX package builds as ``QConv`` (ResnetBlock2D's
``conv1``, ``conv2``, ``conv_shortcut``, Downsample2D's ``conv``) are
``QConv2d``: with an int8 weight (``quant.quantize_dense(...,
convs=True)``) they take ``quant.int8_conv``, the product on the int8 GEMM
kernel over an im2col, then the bias in the output dtype
(``flash_diffusion_tpu/models/layers.py:164-210``). Upsample2D's int8
weight is dequantized in fp32 and cast, as the JAX folded upsampler does
(``layers.py:298-303``; JAX's default path would use the codes without
their scale).
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import dot_product_attention, group_norm, layer_norm
from ..ops.gemm import down_proj_gemm, geglu_down_proj, geglu_h
from ..parallel.mesh import all_reduce_
from ..quant import SCALE_KEY, int8_conv, int8_matmul


class _LoraSwitch(threading.local):
    off = 0  # > 0 inside ``lora_disabled()`` on this thread


_LORA = _LoraSwitch()


@contextlib.contextmanager
def lora_disabled():
    """On this thread, every layer runs without its attached LoRA pair: the
    teacher's forward through a module that the student shares whole (the
    trainer's FSDP mode, where one sharded module serves both). Another
    thread's forwards keep their pairs."""
    _LORA.off += 1
    try:
        yield
    finally:
        _LORA.off -= 1


def lora_enabled() -> bool:
    """False inside ``lora_disabled()`` on this thread."""
    return _LORA.off == 0


def _lora_of(layer: nn.Module):
    return getattr(layer, "lora", None) if lora_enabled() else None


def remat_call(fn, *args):
    """``torch.utils.checkpoint`` (non-reentrant) of ``fn(*args)`` whose
    recompute in the backward, on whichever thread autograd runs it, has
    the LoRA pairs on or off as the forward did (``lora_disabled``)."""
    off = _LORA.off > 0
    ctx = lambda: (contextlib.nullcontext(), lora_disabled() if off else contextlib.nullcontext())
    return checkpoint(fn, *args, use_reentrant=False, context_fn=ctx)


def lora_dense(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], lora=None,
    weight_scale: Optional[torch.Tensor] = None, group=None,
) -> torch.Tensor:
    """``x·Wᵀ (+ bias)`` over the last dim, plus the LoRA side path of the JAX
    ``LoraDense`` when ``lora`` = (A [in, r], B [r, out], scaling) is given:
    ``y = x·Wᵀ + (x·A)·(scaling·B) + bias`` in that order, with A and B cast
    to the compute dtype (x's). ``weight`` is [out, in] (a 1×1 conv's
    [out, in, 1, 1] is read as that). An int8 ``weight`` with its fp32
    ``weight_scale`` [out] takes ``quant.int8_matmul`` for ``x·Wᵀ``; x
    arrives in the compute dtype (the UNet casts its inputs), and the bias
    is added in the output dtype after the product, not in the kernel's
    epilogue, as JAX adds it.

    With a tensor-parallel ``group`` the layer is row-parallel
    (``parallel/tp.py``): x, W and A hold the rank's part of the input
    features, the partial ``x·Wᵀ + (x·A)·B`` is summed over the group, and
    the bias is added once, after the sum (an int8 layer's per-token scale
    is the group's amax)."""
    weight = weight.reshape(weight.shape[0], weight.shape[1])
    if weight.dtype == torch.int8:
        y = int8_matmul(x, weight, weight_scale, group)
    elif lora is None and group is None:
        return F.linear(x, weight, bias)
    else:
        y = F.linear(x, weight)
    y = _lora_side(x, y, lora)
    if group is not None:
        all_reduce_(y, "sum", group)
    return y if bias is None else y + bias.to(y.dtype)


def _lora_side(x: torch.Tensor, y: torch.Tensor, lora) -> torch.Tensor:
    """y + (x·A)·(scaling·B) in y's dtype, or y when ``lora`` is None."""
    if lora is None:
        return y
    a, b, scaling = lora
    b = b * scaling if scaling != 1.0 else b
    return y + (x @ a.to(y.dtype)) @ b.to(y.dtype)


def _dense(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``lora_dense`` with a layer's weight, bias, LoRA pair and int8 scale."""
    return lora_dense(x, layer.weight, layer.bias, _lora_of(layer),
                      getattr(layer, SCALE_KEY, None), getattr(layer, "tp_group", None))


class DenseConv1x1(nn.Conv2d):
    """A 1×1 convolution (the checkpoint's layout: SD1.5's ``proj_in`` and
    ``proj_out``) that runs as the JAX ``LoraDense`` on the tokens, through
    ``_dense``: a LoRA over it is a dense pair (``lora.py``)."""

    def __init__(self, channels: int):
        super().__init__(channels, channels, 1)


class LoraLinear(nn.Linear):
    """``nn.Linear`` (same parameters and state-dict keys) whose forward is
    ``lora_dense``: ``self.lora`` holds an attached factor pair, or None."""

    lora = None

    def forward(self, x):
        return _dense(self, x)


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    max_period: float = 10000.0,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    scale: float = 1.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding, diffusers ``Timesteps`` semantics (SD
    family default: flip_sin_to_cos=True, freq_shift=0), fp32 [B, dim]."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half - downscale_freq_shift)
    emb = scale * (torch.exp(exponent)[None, :] * timesteps.float()[:, None])
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedMLP(nn.Module):
    """linear → SiLU → linear time-embedding MLP (diffusers TimestepEmbedding)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, out_dim)
        self.linear_2 = nn.Linear(out_dim, out_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class GroupNorm(nn.Module):
    """GroupNorm over [B, C, ...] with fp32 statistics and optional fused SiLU."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 act: Optional[str] = None):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm(x, self.num_groups, self.weight, self.bias, self.eps, act=self.act)


class LayerNorm(nn.Module):
    """Affine LayerNorm over the last dim through the LayerNorm kernel."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return layer_norm(x.contiguous(), self.weight, self.bias, eps=self.eps)


class QConv2d(nn.Conv2d):
    """``nn.Conv2d`` (same parameters and state-dict keys) with the JAX
    ``QConv``'s int8 W8A8 branch: when the layer holds a ``weight_scale``
    (its weight int8, ``quant.apply_weights``), ``quant.int8_conv`` and
    then the bias in the output dtype."""

    def forward(self, x):
        scale = getattr(self, SCALE_KEY, None)
        if scale is None:
            return super().forward(x)
        y = int8_conv(x, self.weight, scale, self.stride, self.padding)
        return y if self.bias is None else y + self.bias.to(y.dtype)[:, None, None]


class ResnetBlock2D(nn.Module):
    """GN→SiLU→conv3x3 →(+time)→ GN→SiLU→conv3x3 (+skip 1x1 when widening)."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: Optional[int] = None,
                 groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, groups, eps, act="silu")
        self.conv1 = QConv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels) if temb_dim else None
        self.norm2 = GroupNorm(out_channels, groups, eps, act="silu")
        self.conv2 = QConv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (
            QConv2d(in_channels, out_channels, 1) if in_channels != out_channels else None
        )

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = QConv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest ×2 upsampling, then a 3×3 conv; an int8 weight dequantized
    on the fly (codes · scale in fp32, then the compute dtype)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        scale = getattr(self.conv, SCALE_KEY, None)
        if scale is None:
            return self.conv(x)
        w = (self.conv.weight.float() * scale[:, None, None, None]).to(x.dtype)
        return F.conv2d(x, w, self.conv.bias.to(x.dtype), padding=1)


class Attention(nn.Module):
    """Multi-head attention (self or cross) over token sequences [B, S, C].
    Under tensor parallelism ``num_heads`` is the rank's and the projections
    hold its heads (``parallel/tp.py``): the heads reshape reads the head
    dim off the shard."""

    def __init__(self, query_dim: int, num_heads: int, context_dim: Optional[int] = None,
                 qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        context_dim = context_dim or query_dim
        self.to_q = LoraLinear(query_dim, query_dim, bias=qkv_bias)
        self.to_k = LoraLinear(context_dim, query_dim, bias=qkv_bias)
        self.to_v = LoraLinear(context_dim, query_dim, bias=qkv_bias)
        self.to_out = nn.ModuleList([LoraLinear(query_dim, query_dim)])

    def forward(self, x, context=None, bias=None):
        """``bias``: an additive logits bias broadcastable to [B, H, Sq, Skv]
        (Pixart's cross-attention mask), which takes the plain path."""
        context = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        b, sq, c = q.shape
        h = self.num_heads
        q = q.reshape(b, sq, h, c // h)
        k = k.reshape(b, context.shape[1], h, c // h)
        v = v.reshape(b, context.shape[1], h, c // h)
        out = dot_product_attention(q, k, v, bias=bias)
        return self.to_out[0](out.reshape(b, sq, c))


def _gate_gelu(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's per-dtype GEGLU gate: tanh-gelu in bf16, exact
    (erf) gelu otherwise (``flash_diffusion_tpu/models/layers.py:424``)."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


class GEGLU(nn.Module):
    """The up projection to [value | gate] (diffusers ``ff.net.0``); the
    feed-forward applies the gate."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = LoraLinear(dim, inner * 2)


class GEGLUFeedForward(nn.Module):
    """GEGLU MLP: proj to 2·inner, gelu-gate, project back (diffusers
    ``ff.net``), with the JAX package's fused down-projection modes (module
    docstring). Under either switch the parameters are the same."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), LoraLinear(dim * mult, dim)])

    def forward(self, x):
        out = self.net[2]
        lora = _lora_of(out)
        group = getattr(out, "tp_group", None)  # row-parallel: only rank 0 adds the bias in the epilogue
        bias = out.bias if group is None or dist.get_rank(group) == 0 else None
        x2k = self.net[0].proj(x)  # [a | g], the rank's halves under tensor parallelism
        if os.environ.get("FLASH_TPU_FFN_FUSED", "0") == "1" and x2k.dtype == torch.bfloat16:
            w = out.weight
            if w.dtype == torch.int8:  # dequantized on the fly, as JAX does (not K11)
                w = w.float() * getattr(out, SCALE_KEY)[:, None]
            y = geglu_down_proj(x2k, w.to(x2k.dtype), None if bias is None else bias.to(x2k.dtype))
            return _row_sum(_lora_side(geglu_h(x2k), y, lora), group)
        a, gate = x2k.chunk(2, dim=-1)
        h = a * _gate_gelu(gate)
        if os.environ.get("FLASH_TPU_FFN_DOWN_GEMM", "0") == "1" and out.weight.dtype != torch.int8:
            return _row_sum(_lora_side(h, down_proj_gemm(h, out.weight, bias), lora), group)  # the bias in K10's epilogue
        return out(h)


def _row_sum(y: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel layer's partial products summed over its group."""
    return y if group is None else all_reduce_(y, "sum", group)


class BasicTransformerBlock(nn.Module):
    """LN→self-attn →LN→cross-attn →LN→GEGLU FF, all residual; without
    ``context_dim`` no cross-attention (no ``norm2``/``attn2``, the JAX
    ``cross_attention=False``), and ``context`` is not read."""

    def __init__(self, dim: int, num_heads: int, context_dim: Optional[int]):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, num_heads)
        if context_dim is not None:
            self.norm2 = LayerNorm(dim)
            self.attn2 = Attention(dim, num_heads, context_dim=context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x))
        if hasattr(self, "attn2"):
            x = x + self.attn2(self.norm2(x), context=context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """diffusers Transformer2DModel for UNets: GN → ``proj_in`` → ``depth``
    transformer blocks over the h-major tokens → ``proj_out``.

    ``proj_in``/``proj_out`` are 1×1 convs (SD1.5, the checkpoint's layout)
    or, with ``use_linear_projection``, linear layers (SDXL); either way they
    run as the JAX ``LoraDense`` on the tokens, through ``lora_dense``."""

    def __init__(self, channels: int, num_heads: int, context_dim: Optional[int], groups: int = 32,
                 depth: int = 1, use_linear_projection: bool = False):
        super().__init__()
        proj = (lambda: LoraLinear(channels, channels)) if use_linear_projection else (
            lambda: DenseConv1x1(channels))
        self.norm = GroupNorm(channels, groups, eps=1e-6)
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, num_heads, context_dim) for _ in range(depth)]
        )
        self.proj_out = proj()

    def forward(self, x, context=None):
        b, c, hh, ww = x.shape
        to_tokens = lambda t: t.reshape(b, c, hh * ww).transpose(1, 2).contiguous()  # h-major
        to_image = lambda t: t.transpose(1, 2).reshape(b, c, hh, ww)
        h = _dense(self.proj_in, to_tokens(self.norm(x)))
        for block in self.transformer_blocks:
            h = block(h, context)
        return x + to_image(_dense(self.proj_out, h))  # x first: the sum keeps x's NCHW layout
