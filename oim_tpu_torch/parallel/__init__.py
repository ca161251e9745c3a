"""Parallelism over ``torch.distributed``: the mesh of ranks, named
sharding rules, collectives over mesh axes, sequence parallelism (ring,
zigzag and Ulysses attention, ``parallel/ring.py``), pipeline
parallelism (GPipe, ``parallel/pipeline.py``; 1F1B and interleaved 1F1B,
``parallel/pipeline_1f1b.py``) and the registry bootstrap
(``parallel/bootstrap.py``: ranks taken from the registry's controller
rows, then the process group joined). The port of ``oim_tpu/parallel``;
JAX's ``parallel/compat.py`` is a shim for JAX versions and has no
counterpart.
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
