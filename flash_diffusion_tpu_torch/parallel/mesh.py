"""The distributed runtime of the port: one process per GPU.

Port of ``flash_diffusion_tpu/parallel/mesh.py``. JAX runs one program over
a device mesh and lets GSPMD place every collective; here each rank is a
process of a ``torch.distributed`` group, and the layers, the trainer and
the server place their collectives by hand (``parallel/tp.py``,
``trainer/trainer.py``, ``serving.py``).

- ``initialize_distributed``: the group from torchrun's ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK`` (and ``MASTER_ADDR``/``MASTER_PORT``
  through ``env://``), or from an explicit ``init_method``. A no-op at world
  size 1 when no launcher set them, as JAX's is without a coordinator. The
  backend is the caller's (``nccl`` or ``gloo``), never chosen here. The
  group's ``timeout`` (60 s by default) makes a lost rank fail the others'
  next collective instead of hanging them.
- ``world_size``/``rank``/``is_main`` (1, 0 and True without a group),
  ``local_batch_slice``, ``shard_batch`` (the rank's slice of a global
  batch), ``replicate`` (a broadcast from rank 0).
- ``spawn(fn, world_size, backend)``: a launcher of ``fn(rank, world, *args)``
  in fresh processes over a ``file://`` store in a temporary directory (no
  TCP port to race for), each rank's result or traceback back to the
  caller, every process stopped by the time it returns or raises. On a host
  with fewer cards than ranks the ranks share the cards (rank r on card
  r mod count): two ranks on one card need ``gloo``, which carries CUDA
  tensors for ``all_reduce`` and ``broadcast``; NCCL refuses two ranks on
  one device.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 60.0


def initialize_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                           timeout: float = DEFAULT_TIMEOUT_S, rank: Optional[int] = None,
                           world_size: Optional[int] = None, device: Optional[int] = None):
    """Join the default process group; returns it, or None when there is
    nothing to join (no ``WORLD_SIZE`` in the environment, no
    ``init_method``, no ``world_size``). ``rank``/``world_size`` default to
    ``RANK``/``WORLD_SIZE``; ``init_method`` to ``env://``. With a card,
    the process's device becomes ``cuda:device``, by default
    ``cuda:LOCAL_RANK``, which must be a card of this host (``spawn``
    passes the card its ranks share). An initialized group is returned as
    it is."""
    if dist.is_initialized():
        return dist.group.WORLD
    world = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "0") or 0)
    if not world and init_method is None:
        return None
    if backend not in BACKENDS:
        raise ValueError(f"pass the backend explicitly, one of {BACKENDS} (got {backend!r})")
    world = world or 1
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs a CUDA device")
    if torch.cuda.is_available():
        if device is None:
            device = int(os.environ.get("LOCAL_RANK", rank))
            if device >= torch.cuda.device_count():
                raise RuntimeError(f"LOCAL_RANK {device} has no card: this host has {torch.cuda.device_count()}; "
                                   f"start at most that many processes a host")
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return dist.group.WORLD


def world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0, or no group: the process that logs, checkpoints and exports."""
    return rank() == 0


def local_batch_slice(global_batch_size: int) -> slice:
    """This rank's rows of a global batch (``data/dataset.py`` splits the
    shards themselves by rank)."""
    n, r = world_size(), rank()
    if global_batch_size % n:
        raise ValueError(f"the global batch {global_batch_size} does not split over {n} ranks")
    per = global_batch_size // n
    return slice(r * per, (r + 1) * per)


def shard_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The rank's slice of every entry with a leading batch axis (arrays,
    tensors, lists) of a global batch; scalars pass through. Raises when an
    entry's batch does not split over the group."""
    n, r = world_size(), rank()

    def take(v):
        size = len(v) if isinstance(v, (list, tuple)) else (v.shape[0] if getattr(v, "ndim", 0) >= 1 else None)
        if size is None:
            return v
        if size % n:
            raise ValueError(f"a batch entry of {size} rows does not split over {n} ranks")
        per = size // n
        return v[r * per:(r + 1) * per]

    return {k: take(v) for k, v in batch.items()}


@torch.no_grad()
def replicate(module_or_tensors):
    """Every parameter and buffer (or tensor) broadcast from rank 0 in
    place; returns its argument."""
    if world_size() == 1:
        return module_or_tensors
    if isinstance(module_or_tensors, torch.nn.Module):
        tensors = list(module_or_tensors.parameters()) + list(module_or_tensors.buffers())
    else:
        tensors = list(module_or_tensors)
    for t in tensors:
        dist.broadcast(t.data, 0)
    return module_or_tensors


def all_reduce_(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """In-place all-reduce (``sum``, ``max`` or ``avg``) over ``group``;
    ``avg`` is a sum divided by the world size (gloo has no AVG)."""
    n = world_size(group)
    if n == 1:
        return t
    red = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(t, op=red, group=group)
    if op == "avg":
        t.div_(n)
    return t


def broadcast_object(obj: Any = None) -> Any:
    """``obj`` of rank 0 on every rank (pickled)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def build_kernels_once() -> None:
    """With a card, rank 0 builds (or loads) the kernel library and the
    others wait for it, then load the build (``ops/kernels.py``)."""
    if not torch.cuda.is_available():
        return
    from ..ops import kernels

    if rank() == 0:
        kernels.library()
    if world_size() > 1:
        dist.barrier()
    kernels.library()


# ---------------------------------------------------------------- launcher
def _devices_for(world: int) -> List[int]:
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [r % count if count else r for r in range(world)]


def _entry(fn, rank_, world, backend, init_method, timeout, local_rank, args, queue):
    os.environ.update(RANK=str(rank_), WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank))
    for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):  # every rank on this host: the loopback
        os.environ.setdefault(var, "lo")
    try:
        initialize_distributed(backend, init_method, timeout=timeout, rank=rank_, world_size=world,
                               device=local_rank if torch.cuda.is_available() else None)
        out = fn(rank_, world, *args)
        queue.put((rank_, True, pickle.dumps(out)))
    except BaseException:  # the traceback goes back to the caller, which raises
        queue.put((rank_, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:  # a group broken by a failed rank
                pass


class SpawnError(RuntimeError):
    """A rank of ``spawn`` raised, died or outlived the join timeout."""


def spawn(fn: Callable, world_size: int, backend: str, args: Sequence[Any] = (), timeout: Optional[float] = 600.0,
          group_timeout: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh processes
    joined in one ``backend`` group; returns the ranks' results in rank
    order. ``fn`` and ``args`` must pickle (a module-level function); the
    results are pickled by value. Raises ``SpawnError`` with the first
    failing rank's traceback when a rank raises or exits without a result,
    or when ``timeout`` seconds pass (None: no limit, a server's); every
    process is stopped before this returns or raises."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    store_dir = tempfile.mkdtemp(prefix="fdt_dist_")
    init_method = "file://" + os.path.join(store_dir, "store")
    local_ranks = _devices_for(world_size)
    queue = ctx.Queue()
    procs = [ctx.Process(target=_entry, args=(fn, r, world_size, backend, init_method, group_timeout,
                                              local_ranks[r], tuple(args), queue))
             for r in range(world_size)]
    results: Dict[int, Any] = {}
    failure = None
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + (timeout if timeout is not None else float("inf"))
        while len(results) < world_size and failure is None:
            try:
                r, ok, payload = queue.get(timeout=0.5)
            except Exception:  # queue.Empty: look at the processes
                dead = [r for r, p in enumerate(procs) if not p.is_alive() and r not in results]
                if dead and queue.empty():
                    time.sleep(0.5)  # a result put just before the exit
                    if queue.empty():
                        failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} and no result"
                elif time.monotonic() > deadline:
                    failure = f"the ranks did not finish within {timeout} s"
                continue
            if ok:
                results[r] = pickle.loads(payload)
            else:
                failure = f"rank {r} raised:\n{payload}"
        for p in procs:
            p.join(timeout=30.0 if failure is None else 1.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        queue.close()
        shutil.rmtree(store_dir, ignore_errors=True)
    if failure is not None:
        raise SpawnError(failure)
    return [results[r] for r in range(world_size)]

