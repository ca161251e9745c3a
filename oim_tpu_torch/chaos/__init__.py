"""Chaos engineering over the in-process cluster sim (``oim_tpu/chaos``).

``sim`` assembles a parameterizable in-process cluster (a registry: one
node, a replicated pair or a 3-node quorum; malloc controllers; serve
replicas behind a router; a feeder) with per-component
kill/drain/restart/partition handles, and its engine half alone
(``EngineSim``); ``ladder`` runs seeded, scripted fault schedules over it
and asserts the heal paths CONVERGE — expected events on
``/debug/events``, in order, zero client-visible errors where the retry
contract promises them, byte-identical outputs, zero-leak censuses.

Importing the package loads neither grpcio nor protobuf: the cluster's
gRPC half imports them when a ``ClusterSim`` starts, and the engine rungs
(``ladder.run_engine_rungs``) never do.
"""

from oim_tpu_torch.chaos.ladder import (  # noqa: F401
    RUNGS,
    SMOKE_RUNGS,
    Rung,
    fault_overhead,
    run_ladder,
)
from oim_tpu_torch.chaos.sim import ClusterSim  # noqa: F401
