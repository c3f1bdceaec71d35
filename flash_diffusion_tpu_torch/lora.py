"""LoRA over the port's modules: factor pairs keyed by module name.

Port of ``flash_diffusion_tpu/lora.py``. The JAX package keeps LoRA as a
sparse pytree of (A, B) pairs beside the frozen params; here the pairs are a
dict ``{module name: {"a": A, "b": B}}`` of fp32 tensors, keyed by the
diffusers module names the port's modules carry. The layouts are the JAX
ones, so ``utils/convert.py lora_from_jax`` carries a JAX tree over key for
key: a dense pair is A [in, r], B [r, out] (A·B contracts ``x·A`` first); a
conv pair (a convolution other than a dense 1×1) is A [kh, kw, in, r] with
std 1/√(kh·kw·in), B [r, out], whose product is the HWIO delta that
``lora_delta`` turns to the OIHW weight layout.

The student is the teacher's modules plus the pairs: ``shared_copy`` makes a
second module tree that shares every parameter and buffer with the teacher
(no weight copy), and ``attach_lora`` hands it the pairs. A dense-only tree
takes the side path: each targeted layer gets its pair, which
``models/layers.py lora_dense`` applies as ``x·W + (x·A)·B`` (the JAX
``LoraDense``, with the ``lora_collection`` scaling folded into B). A tree
with a conv pair, or any tree with ``merge=True`` (JAX's ``lora_mode=
"merge"``), takes JAX's merged-weights path (``distill/flash.py:
214-240``): every targeted layer's weight reads W + scaling·Δ(A, B) in W's
dtype, a ``torch.nn.utils.parametrize`` parametrization over the shared W,
evaluated at each read, so that the UNet's ``remat`` recompute in the
backward sees the same merged weight and gradients reach A and B (the
teacher's weights are not touched). Under ``models/layers.py
lora_disabled()`` the parametrization gives W alone: the teacher's view of
a module the student shares whole (the trainer's FSDP mode, where W is the
weight FSDP gathered for the forward). ``base_weight`` is a layer's W
either way. Gradients reach A and B only when the base weights are frozen.

SD1.5's ``proj_in``/``proj_out`` are 1×1 convolutions in the port (the
checkpoint's layout) but ``LoraDense`` layers in JAX: they are
``DenseConv1x1`` modules, whose pairs are dense, so the default tree is
dense-only and takes the side path, as the JAX one does
(``flash.py:226-231``).

PEFT (``to_peft``/``from_peft``, ``save_peft_safetensors``/
``load_peft_safetensors``; JAX ``lora.py:137-224``, ``:332``):
``<prefix>.<module>.lora_A.weight`` [r, in] and ``lora_B.weight`` [out, r],
a conv pair's as [r, in, kh, kw] and [out, r, 1, 1]; the prefix ``unet``
for the UNet, ``transformer`` for the DiT and the MMDiT, as the JAX
pipelines' ``lora_prefix``. The port's module names are PEFT's, so no name
map is needed; over the DiT and the MMDiT the file has no pair for the
inert root ``proj_out``, which the port's tree leaves out.

kohya, for ComfyUI (``to_kohya``/``from_kohya``, ``save_kohya_safetensors``;
JAX ``lora.py:224-331``): ``lora_unet_<module, "." → "_">.lora_down.weight``
(PEFT's A layout), ``.lora_up.weight`` (B's) and an fp32 scalar ``.alpha``
(the rank by default: scaling 1). ``from_kohya`` resolves the flattened
names against the model's own module names and raises on a name two
modules flatten to, or one no module does.
"""

from __future__ import annotations

import copy
import itertools
import re
from typing import Dict, Iterable, List, Optional, Tuple, Union

import torch
import torch.nn as nn
from torch.nn.utils import parametrize

from .models.layers import DenseConv1x1, lora_enabled

LoraTree = Dict[str, Dict[str, torch.Tensor]]

# The JAX ``DEFAULT_TARGETS`` (attention and feed-forward projections, the
# MMDiT's context projections, the spatial transformers' proj_in/proj_out)
# over the port's module names. The leading dot leaves a DiT's or MMDiT's
# root ``proj_out`` out: JAX's pair there is inert (``utils/convert.py
# DIT_INERT_LORA``), so over the DiT the port's tree is JAX's without it
# (per block attn1/attn2 q, k, v, out and the feed-forward's two), and over
# the MMDiT too (per block q, k, v, out, add_q/k/v_proj, to_add_out and
# the image stream's feed-forward; JAX's targets take no ff_context)
DEFAULT_TARGETS = (
    r".*\.(to_q|to_k|to_v|to_out\.0|add_q_proj|add_k_proj|add_v_proj|to_add_out)$",
    r".*\.(proj_in|proj_out|ff\.net\.0\.proj|ff\.net\.2)$",
)


def _dense_like(module: nn.Module) -> bool:
    """A layer JAX runs as a Dense: a linear layer, or SD1.5's 1×1 proj conv."""
    return isinstance(module, (nn.Linear, DenseConv1x1))


def _lora_able(module: nn.Module) -> bool:
    return _dense_like(module) or isinstance(module, nn.Conv2d)


def lora_paths(model: nn.Module, targets=DEFAULT_TARGETS) -> List[str]:
    """Sorted names of the linear and convolution layers matching a target."""
    return sorted(name for name, m in model.named_modules()
                  if _lora_able(m) and any(re.match(p, name) for p in targets))


def lora_scaling(rank: int, alpha: Optional[float] = None) -> float:
    """alpha / rank (PEFT convention); alpha defaults to rank → 1.0."""
    return (rank if alpha is None else alpha) / rank


def init_lora(
    model: nn.Module, rank: int, generator: Optional[torch.Generator] = None,
    targets=DEFAULT_TARGETS, device=None,
) -> LoraTree:
    """{name: {"a": A, "b": 0 [r, out]}} in fp32, so that the student starts
    exactly at the base weights: a dense layer's A ~ N(0, 1/in) [in, r], a
    convolution's A ~ N(0, 1/(kh·kw·in)) [kh, kw, in, r]. Drawn on
    ``device`` (the generator's device) in the order of the sorted names."""
    lora = {}
    for name in lora_paths(model, targets):
        m = model.get_submodule(name)
        w = m.weight
        cout, cin = w.shape[0], w.shape[1]
        if _dense_like(m):
            a = torch.randn(cin, rank, generator=generator, device=device) / cin ** 0.5
        else:
            kh, kw = w.shape[2], w.shape[3]
            a = torch.randn(kh, kw, cin, rank, generator=generator, device=device) / (kh * kw * cin) ** 0.5
        lora[name] = {"a": a, "b": torch.zeros(rank, cout, device=device)}
    return lora


def lora_is_dense_only(lora: LoraTree) -> bool:
    """Every pair is a dense (2-D ``a``) pair, the side path's case."""
    return all(ab["a"].dim() == 2 for ab in lora.values())


def lora_delta(a: torch.Tensor, b: torch.Tensor, shape) -> torch.Tensor:
    """A·B in fp32 in the layout of a weight of ``shape``: a dense pair's
    (A·B)ᵀ [out, in] (a 1×1 conv's [out, in, 1, 1]), a conv pair's HWIO
    product [kh, kw, in, out] as OIHW."""
    a, b = a.float(), b.float()
    if a.dim() == 2:
        return (a @ b).t().reshape(shape)
    kh, kw, cin, r = a.shape
    return (a.reshape(-1, r) @ b).reshape(kh, kw, cin, -1).permute(3, 2, 0, 1)


class _MergedLora(nn.Module):
    """The parametrization W → W + scaling·Δ(A, B), in W's dtype (JAX
    ``merge_lora``'s rounding), or W under ``lora_disabled``; ``lora`` =
    (A, B, scaling) is held by reference, so optimizer updates and
    ``using_lora`` swaps show at once."""

    def __init__(self, lora):
        super().__init__()
        self.lora = lora

    def forward(self, w):
        if not lora_enabled():
            return w
        a, b, scaling = self.lora
        return (w.float() + scaling * lora_delta(a, b, w.shape)).to(w.dtype)


def shared_copy(model: nn.Module) -> nn.Module:
    """A second module tree over the same parameter and buffer tensors."""
    memo = {id(t): t for t in itertools.chain(model.parameters(), model.buffers())}
    return copy.deepcopy(model, memo)


def uses_merge(lora: LoraTree, merge: bool = False) -> bool:
    """The merged-weights path: asked for, or forced by a conv pair (JAX
    ``_student_forward``'s rule)."""
    return merge or not lora_is_dense_only(lora)


def attach_lora(model: nn.Module, lora: LoraTree, scaling: float = 1.0, merge: bool = False) -> nn.Module:
    """Hand each named layer its (A, B, scaling): on the side path of
    ``lora_dense`` for a dense-only tree, else (or with ``merge``) as the
    merged-weights parametrization of every named layer's weight. The
    tensors are referenced, not copied, so optimizer updates show at once.
    Use it on a ``shared_copy``: the merged path parametrizes the modules
    it is given."""
    merged = uses_merge(lora, merge)
    for name, ab in lora.items():
        m = model.get_submodule(name)
        if not merged:
            m.lora = (ab["a"], ab["b"], float(scaling))
        else:
            parametrize.register_parametrization(m, "weight", _MergedLora((ab["a"], ab["b"], float(scaling))),
                                                 unsafe=True)
    return model


def base_weight(module: nn.Module) -> torch.Tensor:
    """A layer's own weight W: under the merged-weights parametrization its
    original (an FSDP shard included), else ``module.weight``."""
    if parametrize.is_parametrized(module, "weight"):
        return module.parametrizations.weight.original
    return module.weight


def lora_slot(model: nn.Module, name: str):
    """The object whose ``lora`` attribute holds the named layer's (A, B,
    scaling): the layer itself (side path) or its merged-weights
    parametrization."""
    m = model.get_submodule(name)
    if parametrize.is_parametrized(m, "weight"):
        return next(p for p in m.parametrizations.weight if isinstance(p, _MergedLora))
    return m


def merge_lora(state: Dict[str, torch.Tensor], lora: LoraTree, scaling: float = 1.0) -> Dict[str, torch.Tensor]:
    """W' = W + scaling·Δ(A, B) on the named layers of a state dict (dense
    and conv pairs), in W's dtype."""
    out = dict(state)
    for name, ab in lora.items():
        w = state[f"{name}.weight"]
        out[f"{name}.weight"] = (w.float() + scaling * lora_delta(ab["a"], ab["b"], w.shape)).to(w.dtype)
    return out


def _peft_a(a: torch.Tensor) -> torch.Tensor:
    """A in PEFT's layout: [r, in], a conv pair's [r, in, kh, kw]."""
    return a.t() if a.dim() == 2 else a.permute(3, 2, 0, 1)


def _peft_b(b: torch.Tensor, conv: bool) -> torch.Tensor:
    """B in PEFT's layout: [out, r], a conv pair's [out, r, 1, 1]."""
    return b.t()[:, :, None, None] if conv else b.t()


def _from_peft_pair(leaf: str, t: torch.Tensor) -> torch.Tensor:
    """A PEFT (or kohya) tensor in the port's layout, fp32."""
    t = t.float()
    if leaf == "a":
        return t.t() if t.dim() == 2 else t.permute(2, 3, 1, 0)
    return t[:, :, 0, 0].t() if t.dim() == 4 else t.t()


def from_peft(tensors: Dict[str, torch.Tensor], alpha: Optional[float] = None,
              prefix: str = "unet") -> Tuple[LoraTree, float]:
    """PEFT tensors of an adapter under ``prefix`` (``unet``; ``transformer``
    for the DiT and the MMDiT) → (LoRA tree, scaling):
    ``{prefix}.{module}.lora_A.weight`` [r, in] becomes ``a`` [in, r] and
    ``lora_B.weight`` [out, r] ``b`` [r, out]; a conv pair's [r, in, kh, kw]
    ``a`` [kh, kw, in, r] and [out, r, 1, 1] ``b`` [r, out]; fp32. The
    scaling is alpha / rank (1 without ``alpha``)."""
    lora: LoraTree = {}
    rank = None
    for key, t in tensors.items():
        if not key.startswith(prefix + "."):
            continue
        stem = key[len(prefix) + 1:]
        for suffix, leaf in ((".lora_A.weight", "a"), (".lora_B.weight", "b")):
            if stem.endswith(suffix):
                break
        else:
            continue
        lora.setdefault(stem[: -len(suffix)], {})[leaf] = _from_peft_pair(leaf, t).contiguous()
        if leaf == "a":
            rank = t.shape[0]
    if rank is None:
        raise ValueError(f"No LoRA tensors found under prefix {prefix!r}")
    return lora, lora_scaling(rank, alpha)


def to_peft(lora: LoraTree, prefix: str = "unet") -> Dict[str, torch.Tensor]:
    """A LoRA tree → PEFT tensors: ``{prefix}.{module}.lora_A.weight`` =
    Aᵀ [r, in] and ``lora_B.weight`` = Bᵀ [out, r] (a conv pair's [r, in,
    kh, kw] and [out, r, 1, 1]), fp32, contiguous, on the CPU
    (``from_peft``'s inverse)."""
    out = {}
    for name, ab in sorted(lora.items()):
        a, b = ab["a"].detach().float(), ab["b"].detach().float()
        out[f"{prefix}.{name}.lora_A.weight"] = _peft_a(a).contiguous().cpu()
        out[f"{prefix}.{name}.lora_B.weight"] = _peft_b(b, a.dim() == 4).contiguous().cpu()
    return out


def save_peft_safetensors(path: str, lora: LoraTree, prefix: str = "unet") -> None:
    """``to_peft`` of ``lora`` written as a ``.safetensors`` file."""
    from safetensors.torch import save_file

    save_file(to_peft(lora, prefix), path)


def load_peft_safetensors(path: str, alpha: Optional[float] = None,
                          prefix: str = "unet") -> Tuple[LoraTree, float]:
    """``from_peft`` of a PEFT ``.safetensors`` file (on the CPU)."""
    from safetensors.torch import load_file

    return from_peft(load_file(path), alpha, prefix)


def to_kohya(lora: LoraTree, prefix: str = "lora_unet", alpha: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """A LoRA tree → the kohya-ss names ComfyUI's LoRA loader reads:
    ``{prefix}_{module, "." → "_"}.lora_down.weight`` (PEFT's A layout),
    ``.lora_up.weight`` (B's) and an fp32 scalar ``.alpha`` a module
    (``alpha``, else the rank: scaling 1, ``lora_scaling``'s default)."""
    out = {}
    for key, t in to_peft(lora, prefix="U").items():
        stem = key[len("U."):]
        if stem.endswith(".lora_A.weight"):
            module, leaf, rank = stem[: -len(".lora_A.weight")], "lora_down", t.shape[0]
        else:
            module, leaf, rank = stem[: -len(".lora_B.weight")], "lora_up", t.shape[1]
        kmod = f"{prefix}_{module.replace('.', '_')}"
        out[f"{kmod}.{leaf}.weight"] = t
        out[f"{kmod}.alpha"] = torch.tensor(float(alpha) if alpha is not None else float(rank), dtype=torch.float32)
    return out


def from_kohya(tensors: Dict[str, torch.Tensor], modules: Union[nn.Module, Iterable[str]],
               prefix: str = "lora_unet") -> Tuple[LoraTree, float]:
    """``to_kohya``'s inverse → (LoRA tree, scaling). kohya flattens "." and
    "_" alike, so each flattened name is resolved against ``modules`` (a
    model, whose linear and convolution layers' names are taken, or the
    names themselves); two names that flatten alike raise ValueError, a
    flattened name no module has raises KeyError. The scaling is alpha /
    rank from the file's ``.alpha``, 1 without one."""
    if isinstance(modules, nn.Module):
        modules = [name for name, m in modules.named_modules() if _lora_able(m)]
    candidates: Dict[str, str] = {}
    for mod in modules:
        flat = mod.replace(".", "_")
        if candidates.get(flat, mod) != mod:
            raise ValueError(f"ambiguous kohya flattening: modules {candidates[flat]!r} and {mod!r} both flatten "
                             f"to {flat!r}")
        candidates[flat] = mod
    lora: LoraTree = {}
    rank = alpha = None
    for key, t in tensors.items():
        if not key.startswith(prefix + "_"):
            continue
        stem = key[len(prefix) + 1:]
        if stem.endswith(".alpha"):
            alpha = float(t)
            continue
        for suffix, leaf in ((".lora_down.weight", "a"), (".lora_up.weight", "b")):
            if stem.endswith(suffix):
                break
        else:
            continue
        flat = stem[: -len(suffix)]
        if flat not in candidates:
            raise KeyError(f"kohya module {flat!r} does not match any module")
        lora.setdefault(candidates[flat], {})[leaf] = _from_peft_pair(leaf, t).contiguous()
        if leaf == "a":
            rank = t.shape[0]
    if rank is None:
        raise ValueError(f"No LoRA tensors found under prefix {prefix!r}")
    return lora, (alpha / rank if alpha is not None else lora_scaling(rank))


def save_kohya_safetensors(path: str, lora: LoraTree, prefix: str = "lora_unet",
                           alpha: Optional[float] = None) -> None:
    """``to_kohya`` of ``lora`` written as a ``.safetensors`` file (ComfyUI's
    ``models/loras``)."""
    from safetensors.torch import save_file

    save_file(to_kohya(lora, prefix, alpha), path)
