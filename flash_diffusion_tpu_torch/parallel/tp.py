"""Tensor parallelism of the port: Megatron column and row layers with
explicit all-reduces.

Port of ``flash_diffusion_tpu/parallel/tp.py``. JAX marks kernels with
column or row partition specs and GSPMD inserts every collective; here
``shard_params_tp(module, group)`` keeps each rank's shard of the weights
in place, and the layers place the all-reduces:

- column-parallel (the output features split): attention ``to_q``,
  ``to_k``, ``to_v``, the MMDiT's ``add_q_proj``/``add_k_proj``/
  ``add_v_proj``, CLIP's ``q_proj``/``k_proj``/``v_proj`` and ``fc1``, T5's
  ``q``/``k``/``v`` and ``wi_0``/``wi_1``, and the feed-forwards' up
  projections ``ff.net.0.proj``/``ff_context.net.0.proj``. Their biases
  and int8 scales split with their rows;
- row-parallel (the input features split): ``to_out.0``, ``to_add_out``,
  ``out_proj``, T5's ``o``, and the down projections ``ff.net.2``,
  ``ff_context.net.2``, ``fc2``, ``wo``. Each rank's partial product (LoRA
  side path included) is summed by an all-reduce over the group, then the
  bias is added once (``models/layers.py``); an int8 layer first takes the
  per-token amax of its activations, and the per-channel amax of its
  weight, over the group (``quant.py``).

The attention projections split by heads: a rank holds ``heads / n`` whole
heads, and its attention modules run at that head count (the head dim is
read off the shard). ``tp_plan`` raises when the head count, or a
feed-forward's width, does not divide over the group; JAX's ``tp_spec_for``
checks only ``shape % n`` and lets GSPMD reshard a split head. GEGLU's up
projection is [value | gate]: each half splits on its own, so that a rank
holds [a_r | g_r] (a contiguous split would give one rank every value row
and the other every gate row). T5's relative-position table [buckets, H]
splits by heads too, so the bias [1, H/n, S, S] it makes is the rank's.

Layers that JAX's patterns name but whose output is needed whole stay
replicated: the UNet's ``proj_in``/``proj_out`` around a spatial
transformer (the residual and the GroupNorm need every channel), the
adaLN modulations (the DiT's ``adaln_single.linear``, the MMDiT's
``norm1.linear``/``norm1_context.linear``/``norm_out.linear``: every
channel's shift, scale and gate reaches every token), and the DiT's and
MMDiT's output ``proj_out`` (the unpatchify needs every channel). Convs,
norms, embeddings and the VAE stay replicated.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from .mesh import rank, world_size

# the Megatron pairs over the port's (diffusers and transformers) names
ATTN_COLUMN = r"(^|\.)(to_q|to_k|to_v|add_q_proj|add_k_proj|add_v_proj|q_proj|k_proj|v_proj|SelfAttention\.[qkv])$"
ATTN_ROW = r"(^|\.)(to_out\.0|to_add_out|out_proj|SelfAttention\.o)$"
FF_COLUMN = r"(^|\.)(ff\.net\.0\.proj|ff_context\.net\.0\.proj|fc1|DenseReluDense\.wi_[01])$"
FF_ROW = r"(^|\.)(ff\.net\.2|ff_context\.net\.2|fc2|DenseReluDense\.wo)$"
# T5's relative-position table [buckets, heads]: split along the heads
HEAD_TABLE = r"(^|\.)relative_attention_bias$"


@dataclasses.dataclass(frozen=True)
class TPShard:
    """How one layer splits: ``kind`` ``"column"`` (weight dim 0, with its
    bias and scale), ``"row"`` (weight dim 1) or ``"table"`` (weight dim 1,
    an embedding's); ``halves``: 2 for GEGLU's [value | gate] rows."""

    kind: str
    halves: int = 1


def _head_owner(module: nn.Module, name: str):
    """(owner name, owner) of the nearest enclosing module with a head
    count (``num_heads`` or ``heads``)."""
    parts = name.split(".")
    for i in range(len(parts) - 1, -1, -1):
        owner_name = ".".join(parts[:i])
        owner = module.get_submodule(owner_name) if owner_name else module
        if hasattr(owner, "num_heads") or hasattr(owner, "heads"):
            return owner_name, owner
    raise ValueError(f"{name}: no enclosing attention module with a head count")


def _heads(owner) -> int:
    return owner.num_heads if hasattr(owner, "num_heads") else owner.heads


def tp_plan(module: nn.Module, n: int) -> Dict[str, TPShard]:
    """{layer name: TPShard} of the layers that split over ``n`` ranks.
    Raises ValueError when an attention's head count or a feed-forward's
    width does not divide by ``n``."""
    from ..models.layers import GEGLU

    plan: Dict[str, TPShard] = {}
    for name, m in module.named_modules():
        if isinstance(m, nn.Embedding) and re.search(HEAD_TABLE, name):
            heads = m.weight.shape[1]
            if heads % n:
                raise ValueError(f"{name}: {heads} heads do not split over {n} ranks")
            plan[name] = TPShard("table")
            continue
        if not isinstance(m, nn.Linear):
            continue
        attn_col, attn_row = re.search(ATTN_COLUMN, name), re.search(ATTN_ROW, name)
        ff_col, ff_row = re.search(FF_COLUMN, name), re.search(FF_ROW, name)
        if attn_col or attn_row:
            owner_name, owner = _head_owner(module, name)
            heads = _heads(owner)
            if heads % n:
                raise ValueError(f"{owner_name or 'the root'}: {heads} heads do not split over {n} ranks")
            plan[name] = TPShard("column" if attn_col else "row")
        elif ff_col or ff_row:
            width = m.out_features if ff_col else m.in_features
            parent = module.get_submodule(name.rpartition(".")[0]) if "." in name else module
            halves = 2 if ff_col and isinstance(parent, GEGLU) else 1
            if width % (halves * n):
                raise ValueError(f"{name}: a feed-forward width of {width // halves} does not split over {n} ranks")
            plan[name] = TPShard("column" if ff_col else "row", halves)
    return plan


def shard_tensor(t: torch.Tensor, dim: int, r: int, n: int, halves: int = 1) -> torch.Tensor:
    """Rank ``r``'s part of ``t`` along ``dim``: each of ``halves`` equal
    parts split in ``n`` and the rank's pieces joined."""
    parts = t.chunk(halves, dim) if halves > 1 else (t,)
    return torch.cat([p.chunk(n, dim)[r] for p in parts], dim).contiguous()


def _dims(s: TPShard):
    """{state leaf: the dim it splits along} of a layer."""
    if s.kind == "column":
        return {"weight": 0, "bias": 0, "weight_scale": 0}
    return {"weight": 1}


def shard_lora(lora, plan: Dict[str, TPShard], r: int, n: int):
    """A LoRA tree ({name: {"a": [in, r], "b": [r, out]}}) cut to rank
    ``r``'s part: B's columns of a column-parallel layer, A's rows of a
    row-parallel one, so that merging a pair into a shard gives the shard of
    the merged weight."""
    out = {}
    for name, ab in lora.items():
        s = plan.get(name)
        if s is None or s.kind == "table":
            out[name] = ab
        elif s.kind == "column":
            out[name] = {"a": ab["a"], "b": shard_tensor(ab["b"], 1, r, n, s.halves)}
        else:
            out[name] = {"a": shard_tensor(ab["a"], 0, r, n), "b": ab["b"]}
    return out


@torch.no_grad()
def shard_params_tp(module: nn.Module, group=None) -> Dict[str, TPShard]:
    """Keep this rank's shard of every planned layer of ``module`` (float
    weights) in place, mark the row-parallel layers with the group
    (``tp_group``, read by ``models/layers.py``) and set each attention's
    head count to the rank's; returns the plan. A no-op plan at world size
    1. Raises before touching anything when a split does not divide."""
    n, r = world_size(group), rank(group)
    if n == 1:
        return {}
    group = group if group is not None else dist.group.WORLD
    plan = tp_plan(module, n)
    owners = {}
    for name, s in plan.items():
        layer = module.get_submodule(name)
        if s.kind == "table":
            layer.weight = nn.Parameter(shard_tensor(layer.weight, 1, r, n), requires_grad=False)
            owners[_head_owner(module, name)[0]] = None
            continue
        for leaf, dim in _dims(s).items():
            t = getattr(layer, leaf, None)
            if t is not None:
                t = shard_tensor(t, dim, r, n, s.halves)
                if leaf in layer._parameters:
                    setattr(layer, leaf, nn.Parameter(t, requires_grad=False))
                else:
                    setattr(layer, leaf, t)
        layer.out_features, layer.in_features = layer.weight.shape[0], layer.weight.shape[1]
        if s.kind == "row":
            layer.tp_group = group
        if re.search(ATTN_COLUMN, name) or re.search(ATTN_ROW, name):
            owners[_head_owner(module, name)[0]] = None
    for owner_name in owners:
        owner = module.get_submodule(owner_name) if owner_name else module
        attr = "num_heads" if hasattr(owner, "num_heads") else "heads"
        setattr(owner, attr, getattr(owner, attr) // n)
    return plan


def tp_sharding_summary(module: nn.Module, n: Optional[int] = None) -> Dict[str, int]:
    """{'column': …, 'row': …, 'replicated': …} over ``module``'s
    parameters as ``tp_plan`` splits them over ``n`` ranks (the group's
    size by default): a column layer's weight and bias and T5's head table
    count as column, a row layer's weight as row and its bias as
    replicated."""
    plan = tp_plan(module, n or world_size())
    counts = {"column": 0, "row": 0, "replicated": 0}
    for key, _ in module.named_parameters():
        name, _, leaf = key.rpartition(".")
        s = plan.get(name)
        if s is None or leaf not in _dims(s):
            counts["replicated"] += 1
        else:
            counts["row" if s.kind == "row" else "column"] += 1
    return counts
