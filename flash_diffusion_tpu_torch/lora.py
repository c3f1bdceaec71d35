"""LoRA over the port's modules: factor pairs keyed by module name.

Port of ``flash_diffusion_tpu/lora.py:35-131``. The JAX package keeps LoRA
as a sparse pytree of (A, B) pairs beside the frozen params; here the pairs
are a dict ``{module name: {"a": A [in, r], "b": B [r, out]}}`` of fp32
tensors, keyed by the diffusers module names the port's UNet carries. The
layouts are the JAX ones (A·B contracts ``x·A`` first), so ``utils/convert.py
lora_from_jax`` carries a JAX tree over key for key.

The student is the teacher's modules plus the side path: ``shared_copy``
makes a second module tree that shares every parameter and buffer with the
teacher (no weight copy), and ``attach_lora`` hands each targeted layer its
pair, which ``models/layers.py lora_dense`` applies as ``x·W + (x·A)·B``
(the JAX ``LoraDense`` with the ``lora_collection`` scaling folded into B).
Gradients reach A and B only when the base weights are frozen.

SD1.5's ``proj_in``/``proj_out`` are 1×1 convolutions in the port (the
checkpoint's layout) but ``LoraDense`` layers in JAX: they are dense pairs
here too, so the LoRA tree is dense-only and always takes the side path,
as the JAX one does (``flash.py:226-231``). ``from_peft`` and
``load_peft_safetensors`` (``lora.py:172``, ``:332``) read a PEFT adapter
(``<prefix>.<module>.lora_A.weight`` [r, in], ``lora_B.weight`` [out, r];
the prefix ``unet`` for the UNet, ``transformer`` for the DiT and the
MMDiT, as the JAX pipelines' ``lora_prefix``) into such a tree: the port's
module names are PEFT's, so no name map is needed. ``to_peft`` and
``save_peft_safetensors`` (``lora.py:137-171``, ``:217-224``) write a tree
back under those names, which diffusers, ``from_peft`` and the JAX
``load_peft_safetensors`` read; over the DiT and the MMDiT the file has no
pair for the inert root ``proj_out``, which the port's tree leaves out.
Kohya export and conv LoRA wait.
"""

from __future__ import annotations

import copy
import itertools
import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

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
    if isinstance(module, nn.Linear):
        return True
    return isinstance(module, nn.Conv2d) and tuple(module.kernel_size) == (1, 1)


def lora_paths(model: nn.Module, targets=DEFAULT_TARGETS) -> List[str]:
    """Sorted names of the linear (or 1×1 conv) layers matching a target."""
    return sorted(
        name for name, m in model.named_modules()
        if _dense_like(m) and any(re.match(p, name) for p in targets)
    )


def lora_scaling(rank: int, alpha: Optional[float] = None) -> float:
    """alpha / rank (PEFT convention); alpha defaults to rank → 1.0."""
    return (rank if alpha is None else alpha) / rank


def init_lora(
    model: nn.Module, rank: int, generator: Optional[torch.Generator] = None,
    targets=DEFAULT_TARGETS, device=None,
) -> LoraTree:
    """{name: {"a": A ~ N(0, 1/in) [in, r], "b": 0 [r, out]}} in fp32, so the
    student starts exactly at the base weights. Drawn on ``device`` (the
    generator's device) in the order of the sorted names."""
    lora = {}
    for name in lora_paths(model, targets):
        w = model.get_submodule(name).weight
        cout, cin = w.shape[0], w.shape[1]
        a = torch.randn(cin, rank, generator=generator, device=device) / cin ** 0.5
        lora[name] = {"a": a, "b": torch.zeros(rank, cout, device=device)}
    return lora


def lora_is_dense_only(lora: LoraTree) -> bool:
    """Every pair is a dense (2-D ``a``) pair, the side path's case."""
    return all(ab["a"].dim() == 2 for ab in lora.values())


def shared_copy(model: nn.Module) -> nn.Module:
    """A second module tree over the same parameter and buffer tensors."""
    memo = {id(t): t for t in itertools.chain(model.parameters(), model.buffers())}
    return copy.deepcopy(model, memo)


def attach_lora(model: nn.Module, lora: LoraTree, scaling: float = 1.0) -> nn.Module:
    """Hand each named layer its (A, B, scaling) for ``lora_dense``; the
    tensors are referenced, not copied, so optimizer updates show at once."""
    for name, ab in lora.items():
        model.get_submodule(name).lora = (ab["a"], ab["b"], float(scaling))
    return model


def merge_lora(state: Dict[str, torch.Tensor], lora: LoraTree, scaling: float = 1.0) -> Dict[str, torch.Tensor]:
    """W' = W + scaling·(A·B)ᵀ on the named layers of a state dict (1×1 conv
    weights keep their shape), in W's dtype."""
    out = dict(state)
    for name, ab in lora.items():
        w = state[f"{name}.weight"]
        delta = (ab["a"].float() @ ab["b"].float()).t() * scaling
        out[f"{name}.weight"] = (w.float() + delta.reshape(w.shape)).to(w.dtype)
    return out


def from_peft(tensors: Dict[str, torch.Tensor], alpha: Optional[float] = None,
              prefix: str = "unet") -> Tuple[LoraTree, float]:
    """PEFT tensors of an adapter under ``prefix`` (``unet``; ``transformer``
    for the DiT and the MMDiT) → (LoRA tree, scaling):
    ``{prefix}.{module}.lora_A.weight`` [r, in] becomes ``a`` [in, r] and
    ``lora_B.weight`` [out, r] ``b`` [r, out], in fp32; the scaling is
    alpha / rank (1 without ``alpha``). Only dense pairs: a conv LoRA (4-D
    ``lora_A``) is not ported yet."""
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
        if t.dim() != 2:
            raise ValueError(f"{key}: only dense (2-D) LoRA pairs are ported, got shape {tuple(t.shape)}")
        lora.setdefault(stem[: -len(suffix)], {})[leaf] = t.float().t().contiguous()
        if leaf == "a":
            rank = t.shape[0]
    if rank is None:
        raise ValueError(f"No LoRA tensors found under prefix {prefix!r}")
    return lora, lora_scaling(rank, alpha)


def to_peft(lora: LoraTree, prefix: str = "unet") -> Dict[str, torch.Tensor]:
    """A LoRA tree → PEFT tensors: ``{prefix}.{module}.lora_A.weight`` =
    Aᵀ [r, in] and ``lora_B.weight`` = Bᵀ [out, r], fp32, contiguous, on the
    CPU (``from_peft``'s inverse)."""
    out = {}
    for name, ab in sorted(lora.items()):
        out[f"{prefix}.{name}.lora_A.weight"] = ab["a"].detach().float().t().contiguous().cpu()
        out[f"{prefix}.{name}.lora_B.weight"] = ab["b"].detach().float().t().contiguous().cpu()
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
