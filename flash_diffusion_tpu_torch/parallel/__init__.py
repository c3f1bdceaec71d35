"""The port's distributed runtime and tensor parallelism (``mesh.py``, ``tp.py``)."""

from .mesh import (
    SpawnError,
    all_reduce_,
    broadcast_object,
    build_kernels_once,
    initialize_distributed,
    is_main,
    local_batch_slice,
    rank,
    replicate,
    shard_batch,
    spawn,
    world_size,
)
from .tp import TPShard, shard_lora, shard_params_tp, shard_tensor, tp_plan, tp_sharding_summary

__all__ = [
    "SpawnError",
    "TPShard",
    "all_reduce_",
    "broadcast_object",
    "build_kernels_once",
    "initialize_distributed",
    "is_main",
    "local_batch_slice",
    "rank",
    "replicate",
    "shard_batch",
    "shard_lora",
    "shard_params_tp",
    "shard_tensor",
    "spawn",
    "tp_plan",
    "tp_sharding_summary",
    "world_size",
]
