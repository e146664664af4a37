"""Distribution and selection helpers (counterpart of ``salun/dist``): the
``--dp N`` context over a torchrun launch (``context``, ``mesh``,
``multihost``); sharded state over the ``(data, model)`` mesh: FSDP over
``data`` (``fsdp``), tensor parallelism of the SD U-Net over ``model``
(``sharding``) and optimizer state parked in host memory
(``host_offload``); and the exact k-th value, on one card or sharded
(``topk``); the sequence-, expert- and pipeline-parallel layers over a
mesh axis (``ring_attention``, ``moe``, ``pipeline``), on the
autograd-visible collectives of ``collectives``."""

from .context import (GlobalBatchNorm2d, activate, active_mesh,
                      all_reduce_, all_reduce_grads, constrain_batch,
                      gather_rows, ingest, mesh_from_flags, place_replicated)
from .fsdp import fsdp_pspecs, full_state_dict, shard_fsdp
from .host_offload import offloaded, to_device, to_host
from .mesh import Mesh, data_sharding, make_mesh, replicate, shard_batch
from .moe import expert_sharding, moe_apply
from .multihost import initialize, process_shard
from .pipeline import pipeline_apply, stack_stage_params, stage_sharding
from .ring_attention import ring_attention
from .sharding import sd_unet_plan, sd_unet_pspecs, shard_params
from .topk import kth_largest, kth_largest_sharded, kth_largest_threshold

__all__ = ["GlobalBatchNorm2d", "Mesh", "activate", "active_mesh",
           "all_reduce_", "all_reduce_grads", "constrain_batch",
           "data_sharding", "expert_sharding", "fsdp_pspecs",
           "full_state_dict", "gather_rows", "ingest", "initialize",
           "kth_largest", "kth_largest_sharded", "kth_largest_threshold",
           "make_mesh", "mesh_from_flags", "moe_apply", "offloaded",
           "pipeline_apply", "place_replicated", "process_shard", "replicate",
           "ring_attention", "sd_unet_plan", "sd_unet_pspecs", "shard_batch",
           "shard_fsdp", "shard_params", "stack_stage_params",
           "stage_sharding", "to_device", "to_host"]
