"""Request router: least-loaded streaming load balancing over N
``oim-serve`` replicas.

PR 6's serving plane caps at one replica; this package is the scale-out
tier (ROADMAP item 2): ``oim-router`` speaks the same ``oim.v1.Serve``
service as the replicas and fans streaming Generate calls out across
every live one. It is the control-plane pattern the registry already
embodies — a thin broker that stays OFF the hot path: routing decisions
ride a lease-filtered cached view of the registry's ``serve/<id>`` rows
(one jittered GetValues poll per interval, not a per-request lookup),
and the token stream itself rides one pooled channel straight to the
chosen replica.

* ``table``  — the replica table: lease-filtered ``serve/<id>`` load
  snapshots refreshed from GetValues with registry endpoint rotation,
  short-TTL cached, draining (``ready: false``) rows evicted.
* ``router`` — the streaming pass-through: least-loaded pick with a
  power-of-two-choices tie-break over the router's own in-flight
  overlay, retry on the NEXT replica only before the first token delta
  (a sampled stream is never silently replayed), client cancel/deadline
  propagated to the upstream slot.
"""

from oim_tpu_torch.router.router import RouterService, router_server  # noqa: F401
from oim_tpu_torch.router.table import Replica, ReplicaTable  # noqa: F401
