"""Batch collation (port of ``flash_diffusion_tpu/data/collation.py:14-34``).

Only the keys common to all samples are collated: numpy arrays and
array-likes stack, scalars and lists of numbers become arrays, strings and
other objects stay Python lists.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


def custom_collation_fn(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    if not samples:
        return {}
    common = set(samples[0].keys())
    for s in samples[1:]:
        common &= set(s.keys())
    batch: Dict[str, Any] = {}
    for key in common:
        values = [s[key] for s in samples]
        first = values[0]
        if isinstance(first, np.ndarray):
            batch[key] = np.stack(values)
        elif hasattr(first, "__array__") and not isinstance(first, (str, bytes)):
            batch[key] = np.stack([np.asarray(v) for v in values])
        elif isinstance(first, (int, float, bool, np.integer, np.floating)):
            batch[key] = np.asarray(values)
        elif isinstance(first, (list, tuple)) and first and isinstance(first[0], (int, float)):
            batch[key] = np.asarray(values)
        else:
            batch[key] = values
    return batch
