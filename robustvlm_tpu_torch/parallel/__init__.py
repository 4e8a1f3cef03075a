"""Parallelism over torch.distributed: the ("data", "fsdp", "model") mesh,
sharded parameters, Megatron tensor parallelism over `model` and
multi-process evaluation (`mesh.py`, `tensor_parallel.py`, `multihost.py`)."""

from robustvlm_tpu_torch.parallel.mesh import (
    batch_sharding,
    full_state_dict,
    make_mesh,
    param_sharding_rules,
    replicate,
    shard_attack,
    shard_params,
    sharded_call,
)
from robustvlm_tpu_torch.parallel.multihost import (
    all_gather_results,
    merge_metric_means,
    process_shard_bounds,
    process_shard_indices,
)

__all__ = ["make_mesh", "batch_sharding", "param_sharding_rules", "shard_params", "replicate",
           "shard_attack", "sharded_call", "full_state_dict", "process_shard_bounds",
           "process_shard_indices", "all_gather_results", "merge_metric_means"]
