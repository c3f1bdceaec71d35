"""DPT monocular depth (MiDaS 3.0 ``dpt_large_384``) of the PyTorch port.

Port of ``flash_diffusion_tpu/models/depth.py:30-250``: a ViT-L/16
backbone (hooks after blocks 5, 11, 17 and 23, the "project" readout), the
DPT reassemble and fusion decoder and the monocular depth head (Ranftl et
al., "Vision Transformers for Dense Prediction"). The module names are
isl-org/MiDaS's (``pretrained.model.*`` backbone, ``pretrained.
act_postprocess{1..4}`` reassemble, ``scratch.*`` decoder), so the official
``dpt_large_384.pt`` state dict loads as it is (``import_dpt_large``
leaves out its dead weights: the backbone's final ``norm`` and ``head``,
and ``scratch.refinenet4.resConfUnit1``, which has no skip input).

The layout at the boundary is JAX's: ``forward(x [B, H, W, 3] in [0, 1])``
normalizes with mean and std 0.5 (the MiDaS DPT transform) and returns the
fp32 inverse relative depth [B, H, W]; the compute dtype is the
parameters' (bf16 on the card: the attention kernels take bf16). The
attention goes through ``ops.dot_product_attention`` (K1, the one-shot
forward, over 577 keys at 384²); LayerNorm (eps 1e-6), the exact GELU and
the convolutions are PyTorch's, as they are XLA's in JAX.

Parity traps against JAX (held in ``tests/test_torch_adapters.py``):

- flax's ``ConvTranspose`` (``transpose_kernel=False``) does not flip its
  kernel, ``F.conv_transpose2d`` does. JAX's ``import_dpt_large`` maps the
  MiDaS weight without a flip, so on the official file JAX's ``up_0`` and
  ``up_1`` compute what MiDaS's would with a flipped kernel. Here the
  MiDaS weights mean what MiDaS means; ``utils/convert.py dpt_from_jax``
  flips JAX's kernels, so that both packages compute the same function on
  the same JAX params;
- the ×2 upsamples are half-pixel bilinear, as ``jax.image.resize``
  (MiDaS's own ``Interpolate`` sets ``align_corners=True``; the port
  follows JAX);
- ``make_depth_fn``'s resizes are antialiased, as ``jax.image.resize`` is
  when it shrinks (``resize_like_jax``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import dot_product_attention

StateDict = Dict[str, torch.Tensor]
# MiDaS weights that no forward reads: the timm backbone's final norm and
# classifier head, and the first residual unit of the fusion block
# without a skip input
DEAD_MIDAS_PREFIXES = ("pretrained.model.norm.", "pretrained.model.head.", "scratch.refinenet4.resConfUnit1.")


def resize_like_jax(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of an NCHW tensor: half-pixel
    bilinear, antialiased when it shrinks (a triangle filter as wide as the
    scale; ``antialias=True`` equals plain bilinear when it grows)."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=True)


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, d // self.heads).unbind(2)
        return self.proj(dot_product_attention(q, k, v).reshape(b, n, d))


class _Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    """Pre-norm ViT block (timm names): x + attn(norm1(x)), then x + mlp(norm2(x))."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ResidualConvUnit(nn.Module):
    """x + conv2(relu(conv1(relu(x)))), NCHW."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusion(nn.Module):
    """MiDaS ``FeatureFusionBlock_custom`` (no deconv, batch norm or
    expand): the skip through ``resConfUnit1`` added, ``resConfUnit2``, ×2
    bilinear (half-pixel, as JAX), the 1×1 ``out_conv``. ``skip=False``: the
    deepest block, which has no skip input."""

    def __init__(self, features: int, skip: bool = True):
        super().__init__()
        if skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = F.interpolate(self.resConfUnit2(x), scale_factor=2, mode="bilinear", align_corners=False)
        return self.out_conv(x)


class _ProjectReadout(nn.Module):
    """The "project" readout: each token ⊕ the class token, Linear + GELU."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tap: torch.Tensor) -> torch.Tensor:
        tokens = tap[:, 1:]
        return self.project(torch.cat([tokens, tap[:, :1].expand_as(tokens)], dim=-1))


class _ViT(nn.Module):
    """The backbone's parameters under timm's names (``patch_embed.proj``,
    ``cls_token``, ``pos_embed``, ``blocks``)."""

    def __init__(self, dim: int, depth: int, heads: int, patch: int, grid: int):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, patch, stride=patch)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, grid * grid + 1, dim))
        nn.init.normal_(self.cls_token, std=0.02)
        nn.init.normal_(self.pos_embed, std=0.02)
        self.blocks = nn.ModuleList([ViTBlock(dim, heads) for _ in range(depth)])


class DPTDepth(nn.Module):
    """ViT-L/16 + DPT decoder + depth head. ``forward(x [B, H, W, 3] in
    [0, 1])`` → [B, H, W] fp32 inverse relative depth, H = W = ``image_size``
    (the position embedding's grid)."""

    def __init__(self, dim: int = 1024, depth: int = 24, heads: int = 16, patch: int = 16,
                 features: int = 256, hooks: Sequence[int] = (5, 11, 17, 23), image_size: int = 384):
        super().__init__()
        self.dim, self.patch, self.hooks = dim, patch, tuple(hooks)
        self.grid = image_size // patch
        self.pretrained = nn.Module()
        self.pretrained.model = _ViT(dim, depth, heads, patch, self.grid)
        chans = (features, features * 2, dim, dim)
        resample = (nn.ConvTranspose2d(chans[0], chans[0], 4, stride=4),
                    nn.ConvTranspose2d(chans[1], chans[1], 2, stride=2), None,
                    nn.Conv2d(chans[3], chans[3], 3, stride=2, padding=1))
        for lvl in range(4):  # MiDaS's Sequential: readout, transpose, unflatten, 1×1 conv, resample
            layers = [_ProjectReadout(dim), nn.Identity(), nn.Identity(), nn.Conv2d(dim, chans[lvl], 1)]
            setattr(self.pretrained, f"act_postprocess{lvl + 1}",
                    nn.Sequential(*layers, *([resample[lvl]] if resample[lvl] is not None else [])))
        self.scratch = nn.Module()
        for i, c in enumerate(chans):
            setattr(self.scratch, f"layer{i + 1}_rn", nn.Conv2d(c, features, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self.scratch, f"refinenet{i}", FeatureFusion(features, skip=i != 4))
        self.scratch.output_conv = nn.Sequential(
            nn.Conv2d(features, features // 2, 3, padding=1), nn.Identity(),  # MiDaS: the ×2 Interpolate
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        vit, post, sc = self.pretrained.model, self.pretrained, self.scratch
        b, h, w, _ = x.shape
        gh, gw = h // self.patch, w // self.patch
        if (gh, gw) != (self.grid, self.grid):
            raise ValueError(f"input {h}×{w}: the position embedding is for {self.grid * self.patch}²")
        dtype = vit.patch_embed.proj.weight.dtype
        x = ((x.float() - 0.5) / 0.5).to(dtype).permute(0, 3, 1, 2)
        t = vit.patch_embed.proj(x).flatten(2).transpose(1, 2)
        t = torch.cat([vit.cls_token.expand(b, 1, self.dim), t], dim=1) + vit.pos_embed
        taps = []
        for i, block in enumerate(vit.blocks):
            t = block(t)
            if i in self.hooks:
                taps.append(t)
        feats = []
        for lvl, tap in enumerate(taps):
            seq = getattr(post, f"act_postprocess{lvl + 1}")
            f = seq[0](tap).transpose(1, 2).reshape(b, self.dim, gh, gw)
            for layer in seq[3:]:
                f = layer(f)
            feats.append(f)
        r = [getattr(sc, f"layer{i + 1}_rn")(f) for i, f in enumerate(feats)]
        p = sc.refinenet4(r[3])
        p = sc.refinenet3(p, r[2])
        p = sc.refinenet2(p, r[1])
        p = sc.refinenet1(p, r[0])
        head = sc.output_conv
        y = F.interpolate(head[0](p), scale_factor=2, mode="bilinear", align_corners=False)
        y = head[5](head[4](head[3](head[2](y))))
        return y[:, 0].float()


def import_dpt_large(sd: Dict[str, object], depth: int = 24) -> StateDict:
    """isl-org/MiDaS ``dpt_large_384.pt`` (torch tensors or numpy arrays) →
    the port's state dict: the keys a ``DPTDepth`` of ``depth`` blocks
    holds, as fp32 tensors, unchanged (the ConvTranspose kernels too: they
    mean here what they mean in MiDaS). The dead weights
    (``DEAD_MIDAS_PREFIXES``) and any other key are left out; a missing key
    raises."""
    with torch.device("meta"):
        keys = list(DPTDepth(dim=8, depth=depth, heads=1, features=8, image_size=16).state_dict())
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"not a MiDaS DPT state dict: missing {missing[:5]}")
    f32 = lambda v: v.detach().to("cpu", torch.float32) if torch.is_tensor(v) else torch.from_numpy(
        np.array(v, np.float32))
    return {k: f32(sd[k]) for k in keys}


def make_depth_fn(model: Union[str, DPTDepth], size: int = 384, device: Union[str, torch.device] = "cuda",
                  dtype: torch.dtype = torch.bfloat16):
    """A ``DepthMapper`` depth fn: HWC float image (0–255 or 0–1) → HW
    inverse depth in [0, 1] (min-max normalized), as JAX's: the image resized
    to ``size``² (antialiased, ``resize_like_jax``), the DPT, the depth
    resized back. ``model``: a ``DPTDepth`` (used on its own device and
    dtype; random weights work) or the path of a local MiDaS
    ``dpt_large_384.pt``, loaded onto ``device`` in ``dtype``."""
    if isinstance(model, str):
        sd = torch.load(model, map_location="cpu", weights_only=True)
        net = DPTDepth(image_size=size)
        net.load_state_dict(import_dpt_large(sd))
        model = net.to(device=device, dtype=dtype).eval()
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def depth_fn(image: np.ndarray) -> np.ndarray:
        img = np.asarray(image, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        h, w = img.shape[:2]
        x = resize_like_jax(torch.from_numpy(img).to(dev).permute(2, 0, 1)[None], (size, size))
        d = model(x.permute(0, 2, 3, 1))
        d = resize_like_jax(d[:, None], (h, w))[0, 0].cpu().numpy()
        lo, hi = d.min(), d.max()
        return (d - lo) / (hi - lo + 1e-8)

    return depth_fn
