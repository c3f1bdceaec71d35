"""Checkpoint and resume, and state-dict shape adaptation.

Port of ``flash_diffusion_tpu/trainer/checkpoint.py:27-89``:

- ``save_state`` writes the trainable state (``TrainingPipeline.state_dict``:
  the LoRA, the discriminator, both optimizers' moments, counts and
  accumulators, the EMA, the step and the trainer's generator state) with
  ``torch.save`` under ``directory/<step>/state.pt``, keeping the newest
  ``keep`` steps as Orbax's ``max_to_keep`` does; frozen modules are
  deterministic imports and are not saved, as in JAX;
- ``restore_state`` reads the latest (or a given) step back, into a
  pipeline when one is given;
- ``rename_keys`` (StateDictRenamer) and ``adapt_state_dict``
  (StateDictAdapter: regex-selected tensors grown with zeros or with noise
  of the source's mean and standard deviation, or narrowed) over nested
  dicts keyed by ``sep``-joined paths, or flat state dicts.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_FILE = "state.pt"


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.isfile(os.path.join(directory, d, _FILE)))


def latest_step(directory: str) -> Optional[int]:
    """The newest complete checkpoint's step under ``directory``, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def save_state(directory: str, step: int, state: Dict[str, Any], keep: Optional[int] = None) -> str:
    """``torch.save`` of ``state`` under ``directory/<step>`` (written aside
    and renamed into place, so a cut run leaves no half checkpoint); then
    only the newest ``keep`` steps stay. Returns the step's directory."""
    final = os.path.join(directory, str(int(step)))
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, _FILE))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    if keep:
        for old in _steps(directory)[:-keep]:
            shutil.rmtree(os.path.join(directory, str(old)), ignore_errors=True)
    return final


def restore_state(directory: str, pipeline=None, step: Optional[int] = None) -> Tuple[Optional[Dict], Optional[int]]:
    """(state, step) of the latest (or the given) step under ``directory``,
    (None, None) when there is none; loaded into ``pipeline`` (a
    ``TrainingPipeline``) when one is given."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return None, None
    state = torch.load(os.path.join(directory, str(int(step)), _FILE), map_location="cpu", weights_only=False)
    if pipeline is not None:
        pipeline.load_state_dict(state)
    return state, step


def _flatten(tree: Dict[str, Any], sep: str, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{sep}{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, sep, key))
        else:
            out[key] = v
    return out


def _unflatten(flat: Dict[str, Any], sep: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        node = out
        *parents, leaf = k.split(sep)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _nested(tree: Dict[str, Any]) -> bool:
    return any(isinstance(v, dict) for v in tree.values())


def rename_keys(tree: Dict[str, Any], key_map: Dict[str, str], sep: str = "/") -> Dict[str, Any]:
    """Rename path prefixes by exact map (StateDictRenamer): a path equal to
    a key of ``key_map``, or under it, takes the mapped prefix; the first
    matching entry wins."""
    nested = _nested(tree)
    flat = _flatten(tree, sep) if nested else dict(tree)
    out = {}
    for k, v in flat.items():
        for old, new in key_map.items():
            if k == old or k.startswith(old + sep):
                k = new + k[len(old):]
                break
        out[k] = v
    return _unflatten(out, sep) if nested else out


def adapt_state_dict(
    tree: Dict[str, Any],
    target_shapes: Dict[str, tuple],
    key_patterns: Optional[list] = None,
    fill: str = "zeros",
    generator: Optional[torch.Generator] = None,
    sep: str = "/",
) -> Dict[str, Any]:
    """Grow or narrow the tensors whose path matches a ``key_patterns`` regex
    (all by default) to ``target_shapes[path]``: the overlap keeps the
    source's values, the rest is zeros (``fill="zeros"``) or normal noise
    with the source's mean and standard deviation (``fill="normal"``, drawn
    from ``generator``). Used to widen ``conv_in`` for concat conditioning."""
    nested = _nested(tree)
    flat = _flatten(tree, sep) if nested else dict(tree)
    patterns = key_patterns or [".*"]
    out = {}
    for k, v in flat.items():
        tgt = target_shapes.get(k)
        if tgt is None or tuple(v.shape) == tuple(tgt) or not any(re.match(p, k) for p in patterns):
            out[k] = v
            continue
        src = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
        if fill == "normal":
            a = src.double()
            result = (torch.randn(tuple(tgt), generator=generator, dtype=torch.float64) * a.std(unbiased=False)
                      + a.mean()).to(src.dtype)
        elif fill == "zeros":
            result = torch.zeros(tuple(tgt), dtype=src.dtype)
        else:
            raise ValueError(f"fill {fill!r}: zeros or normal")
        slices = tuple(slice(0, min(a, b)) for a, b in zip(src.shape, tgt))
        result[slices] = src[slices]
        out[k] = result
    return _unflatten(out, sep) if nested else out
