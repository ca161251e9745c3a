"""Serve-replica registration (``oim_tpu/serve/registration.py``):
TTL-leased ``serve/<id>`` registry keys, in JAX's row format, so JAX's
router routes to a port replica.

The controller's lease/heartbeat machinery (controller/controller.py),
applied to the serving tier: every ``oim-serve`` replica publishes ONE
registry key, ``serve/<serve-id>``, whose value is a JSON load snapshot
(endpoint + free decode slots + queue depth from ``ServeEngine.stats()``)
written with a lease. Because the load changes every beat, the heartbeat
IS a re-publish — each ``SetValue`` refreshes both the snapshot and the
lease in one RPC, so there is no separate Heartbeat bookkeeping to drift
out of sync with the advertised load. Dead replicas vanish from
``GetValues`` exactly like dead controllers do (the router's table is
lease-filtered); a draining replica flips ``ready: false`` one beat
early so routers rotate away before the listener dies.

The publish-and-renew loop itself — jittered backoff, registry endpoint
rotation, pooled channels, the monotonic ``beat`` stamp, delete-on-stop
— is the shared ``common/telemetry.py RegistryRowPublisher`` (this
module invented it; the observability plane's ``telemetry/<id>`` rows
ride the same base).
"""

from __future__ import annotations

import grpc

from oim_tpu_torch.common import channelpool
from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.common.telemetry import RegistryRowPublisher
from oim_tpu_torch.common.tlsutil import TLSConfig

# Top-level registry namespace for serving replicas: serve/<serve-id> ->
# JSON load snapshot. Component-wise prefix semantics make GetValues
# ("serve") the router's whole topology read.
from oim_tpu_torch.common.pathutil import REGISTRY_SERVE as SERVE_PREFIX


def serve_key(serve_id: str) -> str:
    if not serve_id or "/" in serve_id:
        raise ValueError(f"serve id must be a single path component, "
                         f"got {serve_id!r}")
    return f"{SERVE_PREFIX}/{serve_id}"


def load_snapshot(endpoint: str, engine) -> dict:
    """The JSON value under ``serve/<id>``: routing endpoint + the
    engine's load counters (``ServeEngine.stats()``) + the hot
    prefix-cache advertisement the router's affinity pick matches
    against. The advertisement rides the EXISTING heartbeat re-publish —
    the row value already carries the live load snapshot, so what a
    replica holds and how loaded it is can never drift apart, and a
    pre-prefix-cache engine (no ``hot_prefixes``) simply publishes no
    advertisement: routers treat it as holding nothing and route it on
    load alone (mixed-version safe)."""
    snap = {"endpoint": endpoint}
    snap.update(engine.stats())
    hot = getattr(engine, "hot_prefixes", None)
    if callable(hot):
        hashes = hot()
        if hashes:
            snap["prefix_block"] = engine.prefix_block
            snap["prefix_hashes"] = list(hashes)
    # KV tiering (serve/kvtier.py): the per-chain tier map and the
    # exported-volume map ride the same row, getattr-guarded twice
    # over — a pre-tier engine publishes neither key, and a pre-tier
    # ROUTER ignores both (Replica.parse reads only fields it knows),
    # so every mixed-version pairing degrades to the pre-tier behavior.
    tiers = getattr(engine, "prefix_tiers", None)
    if callable(tiers):
        tier_map = tiers()
        if tier_map:
            snap.setdefault("prefix_block", engine.prefix_block)
            snap["prefix_tiers"] = tier_map
    vols = getattr(engine, "exported_volumes", None)
    if callable(vols):
        vol_map = vols()
        if vol_map:
            snap["prefix_volumes"] = vol_map
    return snap


class ServeRegistration(RegistryRowPublisher):
    """Publish-and-renew loop for one serve replica's registry row.

    ``start()`` runs the loop in a daemon thread; ``beat_once()`` is the
    unit the loop (and tests) drive: one SetValue of the current load
    snapshot with ``lease_seconds``. ``announce_draining()`` re-publishes
    immediately with ``ready: false`` (called at the top of a graceful
    drain); ``stop(deregister=True)`` deletes the key so routers drop
    the replica without waiting out the lease.
    """

    THREAD_NAME = "oim-serve-registration"

    def __init__(
        self,
        serve_id: str,
        endpoint: str,
        engine,
        registry_address: str,
        interval: float = 10.0,
        lease_seconds: float = 0.0,
        tls: TLSConfig | None = None,
        pool: channelpool.ChannelPool | None = None,
        version: str = "",
    ):
        # republish_every=1: the load row PUBLISHES every beat, never
        # batch-renews — the snapshot is the advertisement (load, prefix
        # hashes), and the router's mark_failed re-admission contract is
        # "the row CHANGED" (a renewal would freeze a failed-but-alive
        # replica out for the whole renewal window). The batch path is
        # for value-stable rows (telemetry/<id>).
        super().__init__(
            serve_key(serve_id), registry_address,
            interval=interval, lease_seconds=lease_seconds,
            tls=tls, pool=pool, republish_every=1)
        self.serve_id = serve_id
        self.endpoint = endpoint
        self.engine = engine
        # Weights-version advertisement for rolling upgrades: stamped
        # into every heartbeat so the router can tell v1 from v2 rows
        # and the autoscaler can drain stale replicas one at a time.
        # Empty = unversioned (pre-upgrade build or operator opt-out):
        # the row simply carries no "version" key, and readers treat
        # that as "any version" (mixed-version safe).
        self.version = version

    def snapshot(self) -> dict:
        snap = load_snapshot(self.endpoint, self.engine)
        if self.version:
            snap["version"] = self.version
        return snap

    def beat_once(self, ready: bool | None = None) -> dict:
        """One heartbeat: publish the current load snapshot with the
        lease. ``ready`` overrides the engine's own readiness (the
        draining announcement). Returns the published snapshot."""
        overrides = {} if ready is None else {"ready": ready}
        return super().beat_once(**overrides)

    def announce_draining(self) -> None:
        """Best-effort immediate ``ready: false`` re-publish, so routers
        rotate away from this replica BEFORE its listener dies (resident
        streams keep draining through the still-open connections)."""
        try:
            self.beat_once(ready=False)
        except grpc.RpcError as err:
            from_context().warning(
                "draining announcement failed", serve=self.serve_id,
                error=err.code().name)
