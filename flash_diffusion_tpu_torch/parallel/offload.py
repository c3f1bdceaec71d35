"""Frozen weights that live on the host and move to the device in bursts.

The port's counterpart of the JAX trainer's text-encoder offload
(``flash_diffusion_tpu/trainer/trainer.py:110-121``, ``:305-330``): the
towers' arrays are kept in host memory and placed on the device for a
burst of encodes. ``HostOffload`` holds a module's tensors so:

- a parameter that FSDP2 manages (``fully_shard``) moves as this rank's
  shard: the flat, padded shard that FSDP all-gathers from
  (``FSDPParam._sharded_param_data``) and the DTensor's local tensor, a
  prefix view of it, are pointed at the host copy or at the device copy
  together, so each block is still gathered from its shard in its own
  forward; FSDP keeps each shard in storage of its own, which a swap of
  the parameter's ``.data`` would not reach;
- any other parameter or buffer moves by its ``.data``.

The host copies are packed into chunks of a power of two bytes each,
pinned when the device is a GPU (the pinned allocator rounds every
allocation up to a power of two, so chunks waste nothing where one pinned
tensor a weight would pin up to twice the towers' bytes). ``place`` is one
asynchronous copy a chunk; ``release`` points every tensor back at its host
copy, which never changes (the weights are frozen), and lets the device
copies go.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, List, Tuple

import torch

ALIGN = 512  # bytes between packed tensors
CHUNK_BYTES = 1 << 30


def fsdp_params(module: torch.nn.Module) -> list:
    """The ``FSDPParam`` of every parameter FSDP2 manages under ``module``."""
    from torch.distributed.fsdp import FSDPModule

    out = []
    for m in module.modules():
        if not isinstance(m, FSDPModule):
            continue
        state = m._get_fsdp_state()
        groups = getattr(state, "_fsdp_param_groups", None)
        if groups is None:  # one group a module before torch 2.7
            groups = [g for g in (getattr(state, "_fsdp_param_group", None),) if g is not None]
        for group in groups:
            out.extend(group.fsdp_params)
    return out


def _fsdp_slot(fp) -> Tuple[torch.Tensor, Callable[[torch.Tensor], None]]:
    local = fp.sharded_param._local_tensor
    flat = fp._sharded_param_data
    if local.numel() and (local.data_ptr() != flat.data_ptr() or not local.is_contiguous()):
        raise RuntimeError("an FSDP shard whose local tensor is not a prefix of its padded flat shard")
    shape, n = local.shape, local.numel()

    def point(t: torch.Tensor) -> None:
        fp._sharded_param_data = t
        fp.sharded_param._local_tensor = t[:n].view(shape)

    return flat, point


def _plain_slot(t: torch.Tensor) -> Tuple[torch.Tensor, Callable[[torch.Tensor], None]]:
    shape = t.shape

    def point(flat: torch.Tensor) -> None:
        t.data = flat.view(shape)

    return t.detach().reshape(-1), point


class HostOffload:
    """``module``'s parameters and buffers on the host except between
    ``place()`` and ``release()``; ``nbytes`` is what a placement puts on
    ``device`` (this rank's shards of FSDP's parameters)."""

    def __init__(self, module: torch.nn.Module, device):
        from torch.distributed.fsdp import FSDPModule
        from torch.distributed.tensor import DTensor

        self.device = torch.device(device)
        self.modules = [m for m in module.modules() if isinstance(m, FSDPModule)]  # resharded on release
        sharded = fsdp_params(module)
        managed = {id(fp.sharded_param) for fp in sharded}
        slots = [_fsdp_slot(fp) for fp in sharded]
        for t in itertools.chain(module.parameters(), module.buffers()):
            if id(t) not in managed and not isinstance(t, DTensor):
                slots.append(_plain_slot(t))
        self._points = [point for _, point in slots]
        self._layout, chunk_sizes = self._pack([flat for flat, _ in slots])
        pin = self.device.type == "cuda"
        self._host = [torch.empty(size, dtype=torch.uint8, pin_memory=pin) for size in chunk_sizes]
        self._host_views = []
        with torch.no_grad():
            for (flat, point), where in zip(slots, self._layout):
                view = self._view(self._host, where)
                view.copy_(flat)
                point(view)
                self._host_views.append(view)
        self.nbytes = sum(flat.numel() * flat.element_size() for flat, _ in slots)
        self._device_chunks = None

    @staticmethod
    def _pack(flats: List[torch.Tensor]):
        """(chunk, byte offset, numel, dtype) of each tensor, and the chunks'
        sizes: powers of two, at most ``CHUNK_BYTES`` unless one tensor is
        larger."""
        sizes = [f.numel() * f.element_size() for f in flats]
        cap = max([CHUNK_BYTES] + [1 << max(0, math.ceil(math.log2(max(s, 1)))) for s in sizes])
        layout, used = [], [0]
        for f, size in zip(flats, sizes):
            at = -(-used[-1] // ALIGN) * ALIGN
            if at + size > cap:
                used.append(0)
                at = 0
            layout.append((len(used) - 1, at, f.numel(), f.dtype))
            used[-1] = at + size
        return layout, [1 << max(0, math.ceil(math.log2(max(u, 1)))) for u in used]

    @staticmethod
    def _view(chunks, where) -> torch.Tensor:
        chunk, at, n, dtype = where
        size = n * torch.empty((), dtype=dtype).element_size()
        return chunks[chunk][at: at + size].view(dtype)

    @property
    def placed(self) -> bool:
        return self._device_chunks is not None

    def place(self) -> None:
        """Every tensor on the device (one copy a chunk, asynchronous from
        pinned memory)."""
        if self.placed:
            return
        self._device_chunks = [c.to(self.device, non_blocking=True, copy=True) for c in self._host]
        for point, where in zip(self._points, self._layout):
            point(self._view(self._device_chunks, where))

    def release(self) -> None:
        """Every tensor back on its host copy; FSDP's gathered parameters
        resharded, so that nothing of the module stays on the device."""
        if not self.placed:
            return
        for m in self.modules:
            m.reshard()
        for point, view in zip(self._points, self._host_views):
            point(view)
        self._device_chunks = None
