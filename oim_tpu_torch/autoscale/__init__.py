"""Fleet actuator: the SLO-driven reconcile loop that closes the
control loop oim-monitor's alert rows opened.

The monitor senses (telemetry -> burn rates -> TTL-leased
``alert/<name>`` rows, obs/); this package acts on them, pure
control-plane style (PAPER.md §0 — no data-path scrape anywhere):

* ``reconcile`` — the decision core as pure functions: ``plan()``
  (declared FleetSpec vs observed replicas vs firing alerts -> spawn/
  drain actions, with cooldown flap-damping, scale-to-zero, and
  rolling-upgrade waves) and ``LeaderGate`` (lease-as-leadership over
  the ``fleet/`` row, with monotonic-beat freshness so a replayed
  stale row never wins).
* ``launcher`` — the actuation seam: ``ReplicaLauncher`` protocol +
  ``SubprocessLauncher`` (real ``oim-serve`` processes; prestage-first
  spawns, SIGTERM drains). The chaos sim's ``SimReplicaLauncher``
  implements the same seam in-process for tests.
* ``daemon`` — the ``oim-autoscaler`` core: ONE root-prefix Watch
  stream (GetValues poll fallback) feeding ``plan()`` on a tick, the
  leader publishing its desired state as the TTL-leased
  ``fleet/autoscaler`` row a standby defers to.

``reconcile`` is pure stdlib, so tests and ``oimctl`` import it
without touching grpc or the model stack.
"""

from oim_tpu_torch.autoscale.reconcile import (  # noqa: F401
    Action,
    FleetSpec,
    LeaderGate,
    ObservedReplica,
    ReconcileState,
    plan,
)
from oim_tpu_torch.autoscale.launcher import (  # noqa: F401
    ReplicaLauncher,
    SubprocessLauncher,
)


def __getattr__(name):
    # daemon.py imports grpc at its top: Autoscaler and fleet_key load on
    # first use, so reconcile and launcher import without grpcio.
    if name in ("Autoscaler", "fleet_key"):
        from oim_tpu_torch.autoscale import daemon
        return getattr(daemon, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Action",
    "Autoscaler",
    "FleetSpec",
    "LeaderGate",
    "ObservedReplica",
    "ReconcileState",
    "ReplicaLauncher",
    "SubprocessLauncher",
    "fleet_key",
    "plan",
]
