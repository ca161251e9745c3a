"""Parallelism over ``torch.distributed``: the mesh of ranks, named
sharding rules, collectives over mesh axes, and sequence parallelism
(ring, zigzag and Ulysses attention, ``parallel/ring.py``). The port of
``oim_tpu/parallel``; the pipeline schedules and the registry bootstrap
are not ported yet.
"""

from oim_tpu_torch.parallel.mesh import (
    MeshAxes,
    build_mesh,
    local_mesh,
    mesh_from_topology,
    topology_from_registry,
)
from oim_tpu_torch.parallel.sharding import (
    BATCH,
    EXPERT,
    HEAD,
    MLP,
    SEQ,
    VOCAB,
    ShardingRules,
    logical_sharding,
    shard_batch,
    shard_params,
)

__all__ = [
    "MeshAxes",
    "build_mesh",
    "local_mesh",
    "mesh_from_topology",
    "topology_from_registry",
    "ShardingRules",
    "logical_sharding",
    "shard_batch",
    "shard_params",
    "BATCH",
    "SEQ",
    "HEAD",
    "MLP",
    "VOCAB",
    "EXPERT",
]
