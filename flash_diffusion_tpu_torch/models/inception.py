"""InceptionV3 pool3 feature extractor (FID features) of the PyTorch port.

Port of ``flash_diffusion_tpu/models/inception.py``: torchvision's
``inception_v3`` trunk through the 2048-d global average pool, with
torchvision's module names (``Conv2d_1a_3x3.conv``, ``Mixed_5b.branch1x1.bn``,
…), so a torchvision or pytorch-fid state dict loads by its own keys less
the ``fc`` head and ``AuxLogits``. Each ``BasicConv`` is conv (no bias) →
``BatchNorm2d`` (eps 1e-3, eval mode) → ReLU, which is the JAX package's
folded (scale, bias) up to fp32 rounding.

``fid_variant=True`` is pytorch-fid's canonical FID network (the
``pt_inception-2015-12-05`` checkpoint): the branch average pools of
Mixed_5b–6e and Mixed_7b divide by the real elements of an edge window
(``count_include_pad=False``), Mixed_7c's pool branch is a 3×3/1 max
pool. ``fid_variant=False`` is torchvision's stock network. The 3×3/2 max
pools are unpadded. Runs in fp32 (cuDNN's convolutions with TF32 off, the
port's fp32 policy: ``sample.build_pipeline`` turns it off); there is no
port kernel inside.

Layout at the boundary, as JAX: ``forward(x [B, H, W, 3] in [-1, 1])`` at
299² (``preprocess`` resizes as ``jax.image.resize``, antialiased when it
shrinks) → [B, 2048].
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .depth import resize_like_jax

StateDict = Dict[str, torch.Tensor]
BN_EPS = 1e-3


class BasicConv(nn.Module):
    """conv (no bias) → BatchNorm (eps 1e-3) → ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool3(x, fid: bool):
    # pytorch-fid's FIDInception blocks pass count_include_pad=False: edge
    # windows divide by the number of real elements, not the window size
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=not fid)


def _max_pool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, fid: bool = False):
        super().__init__()
        self.fid = fid
        self.branch1x1 = BasicConv(cin, 64, 1)
        self.branch5x5_1 = BasicConv(cin, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool3(x, self.fid))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool3s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, fid: bool = False):
        super().__init__()
        self.fid = fid
        self.branch1x1 = BasicConv(cin, 192, 1)
        self.branch7x7_1 = BasicConv(cin, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool3(x, self.fid))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool3s2(x)], 1)


class InceptionE(nn.Module):
    """``pool``: "avg" (torchvision), "avg_fid" (pytorch-fid's FIDInceptionE_1,
    count_include_pad=False) or "max" (FIDInceptionE_2)."""

    def __init__(self, cin: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv(cin, 320, 1)
        self.branch3x3_1 = BasicConv(cin, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        pooled = (F.max_pool2d(x, 3, stride=1, padding=1) if self.pool == "max"
                  else _avg_pool3(x, self.pool == "avg_fid"))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], 1)


class InceptionV3Pool3(nn.Module):
    """The FID feature trunk: ``forward(x [B, H, W, 3] in [-1, 1])`` →
    [B, 2048] pool3 features; ``fid_variant`` as the module docstring."""

    def __init__(self, fid_variant: bool = False):
        super().__init__()
        fid = self.fid_variant = fid_variant
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fid)
        self.Mixed_5c = InceptionA(256, 64, fid)
        self.Mixed_5d = InceptionA(288, 64, fid)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fid)
        self.Mixed_6c = InceptionC(768, 160, fid)
        self.Mixed_6d = InceptionC(768, 160, fid)
        self.Mixed_6e = InceptionC(768, 192, fid)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg_fid" if fid else "avg")
        self.Mixed_7c = InceptionE(2048, "max" if fid else "avg")
        self.eval()  # BatchNorm with its running statistics: inference only

    def forward(self, x):
        x = x.to(self.Conv2d_1a_3x3.conv.weight.dtype).permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool3s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool3s2(x)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return x.mean(dim=(2, 3))  # global average pool → [B, 2048]


def preprocess(images: torch.Tensor, size: int = 299) -> torch.Tensor:
    """[-1, 1] NHWC → 299², resized as ``jax.image.resize(..., "bilinear")``
    (pytorch-fid's convention)."""
    x = torch.as_tensor(images).float()
    if tuple(x.shape[1:3]) != (size, size):
        x = resize_like_jax(x.permute(0, 3, 1, 2), (size, size)).permute(0, 2, 3, 1)
    return x


def import_inception_v3(sd: StateDict) -> StateDict:
    """A torchvision ``inception_v3`` (or pytorch-fid ``pt_inception``)
    state dict → ``InceptionV3Pool3``'s: the trunk's keys, the ``fc`` head
    and ``AuxLogits`` left out. Accepts torch tensors or numpy arrays."""
    return {k: torch.as_tensor(v) for k, v in sd.items() if not k.startswith(("fc.", "AuxLogits."))}


def load_inception_v3(path: str, fid_variant: bool = False, device="cuda") -> InceptionV3Pool3:
    """``InceptionV3Pool3`` on ``device`` from a local torchvision-named
    checkpoint (``.pth`` or ``.safetensors``); no network access."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    with torch.device("meta"):
        net = InceptionV3Pool3(fid_variant)
    net.load_state_dict(import_inception_v3(sd), assign=True)
    return net.to(device).eval()
