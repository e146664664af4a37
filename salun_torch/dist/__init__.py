"""Data parallelism and selection helpers (counterpart of ``salun/dist``):
the ``--dp N`` context over a torchrun launch (``context``, ``mesh``,
``multihost``) and the exact k-th value (``topk``). FSDP, tensor
parallelism and the beyond-reference modes are not ported yet."""

from .context import (GlobalBatchNorm2d, activate, active_mesh,
                      all_reduce_, all_reduce_grads, constrain_batch,
                      gather_rows, ingest, mesh_from_flags, place_replicated)
from .mesh import Mesh, data_sharding, make_mesh, replicate, shard_batch
from .multihost import initialize, process_shard
from .topk import kth_largest, kth_largest_threshold

__all__ = ["GlobalBatchNorm2d", "Mesh", "activate", "active_mesh",
           "all_reduce_", "all_reduce_grads", "constrain_batch",
           "data_sharding", "gather_rows", "ingest", "initialize",
           "kth_largest", "kth_largest_threshold", "make_mesh",
           "mesh_from_flags", "place_replicated", "process_shard",
           "replicate", "shard_batch"]
