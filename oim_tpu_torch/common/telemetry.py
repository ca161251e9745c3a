"""TTL-leased registry row publishing (``oim_tpu/common/telemetry.py``):
the shared publish-and-renew loop, and the ``telemetry/<id>``
self-registration every daemon uses. The rows are JAX's: a port daemon's
row reads as a JAX daemon's to ``oimctl --top``, the router and the SLO
monitor.

The serving tier invented the pattern (serve/registration.py): one
registry key whose VALUE is a live JSON snapshot, re-published every
beat, so the heartbeat IS the refresh — no separate bookkeeping to
drift. ``RegistryRowPublisher`` is that loop factored out: jittered
exponential backoff through registry outages, endpoint rotation on
UNAVAILABLE/FAILED_PRECONDITION (replicated pair), pooled channels with
transport-failure eviction, a monotonic ``beat`` counter stamped into
every snapshot (consumers tell a fresh heartbeat from the frozen row of
a dead publisher), and delete-on-stop. ``ServeRegistration`` subclasses
it for ``serve/<id>`` load rows; ``TelemetryRegistration`` (here) for
the observability plane.

Telemetry rows make the cluster self-describing for ``oimctl --top``:
every daemon publishes ``telemetry/<id>`` -> ``{"metrics":
"host:port", "role": "...", "pid": ...}`` with a lease, so one registry
read yields every live metrics endpoint — dead daemons vanish when the
lease lapses, exactly like dead controllers. The registry's authz
extends the ``serve/`` reservation pattern to this namespace
(registry.py ``_may_set``): an identity may write only its OWN
``telemetry/<own-id>`` row (or a dot-suffixed variant for co-located
processes), and no controller may claim the bare id ``telemetry``.
"""

from __future__ import annotations

import json
import os
import threading

import grpc

from oim_tpu_torch.common import channelpool
from oim_tpu_torch.common.backoff import ExponentialBackoff
from oim_tpu_torch.common.endpoints import FAILOVER_CODES, RegistryEndpoints
from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.common.pathutil import REGISTRY_TELEMETRY
from oim_tpu_torch.common.tlsutil import TLSConfig
from oim_tpu_torch.spec import oim_pb2 as pb
from oim_tpu_torch.spec.services import RegistryStub


def telemetry_key(telemetry_id: str) -> str:
    if not telemetry_id or "/" in telemetry_id:
        raise ValueError(f"telemetry id must be a single path component, "
                         f"got {telemetry_id!r}")
    return f"{REGISTRY_TELEMETRY}/{telemetry_id}"


def metrics_snapshot() -> dict:
    """The fleet-mergeable metrics payload a telemetry row carries each
    beat (oim_tpu/obs/merge.py snapshot format): cumulative bucket
    snapshots of the latency histograms the SLO plane merges, plus the
    ``requests_total{outcome}`` counters the availability SLO needs.

    Every daemon publishes ``rpc`` (the interceptors record it on every
    process); the serve-side series ride only when they have
    observations (a router's zero first-token histogram is dead weight
    in every heartbeat, and absence is what keeps non-serving roles'
    rows small). A pre-upgrade daemon simply publishes no ``hist`` at
    all — consumers dash-degrade (the mixed-version stance).

    The ``rpc`` series EXCLUDES the registry row-renewal methods
    (SetValue / Heartbeat): the publisher's own beat records an RPC
    latency sample, so including them would make every snapshot differ
    from the last and silently demote every value-stable row from
    batched Heartbeat renewal back to publish-every-beat — the
    instrument observing itself. The data-path methods the RPC SLO
    cares about (Generate, ReadVolume, Watch, MapVolume, ...) all
    ride."""
    from oim_tpu_torch.common import metrics as M

    renewal = {"oim.v1.Registry/SetValue", "oim.v1.Registry/Heartbeat"}
    hist = {
        "rpc": M.RPC_LATENCY.merged_snapshot(
            skip=lambda labels: labels.get("method") in renewal),
    }
    for key, family, labels in (
            ("first_token", M.SERVE_TOKEN_LATENCY, {"kind": "first"}),
            ("inter_token", M.SERVE_TOKEN_LATENCY, {"kind": "next"}),
            ("queue_wait", M.SERVE_QUEUE_WAIT, None),
    ):
        snap = family.merged_snapshot(labels)
        if snap["counts"][-1] > 0:
            hist[key] = snap
    payload: dict = {"hist": hist}
    requests = {
        key[0]: value
        for key, value in M.SERVE_REQUESTS_TOTAL.labeled_values().items()
        if value > 0
    }
    if requests:
        payload["counters"] = {"requests_total": requests}
    return payload


class RegistryRowPublisher:
    """Publish-and-renew loop for one TTL-leased registry row.

    ``start()`` runs the loop in a daemon thread; ``beat_once()`` is the
    unit the loop (and tests) drive. When the snapshot CHANGED (or every
    ``republish_every``-th beat, as the resync bound) it is one SetValue
    of ``snapshot()`` with ``lease_seconds``; between those, an
    unchanged row renews by a batched ``Heartbeat(keys=[row])`` — no
    value payload, no journal record on the registry, the ROADMAP
    "batch heartbeats" item. A pre-batch registry leaves ``keys_known``
    empty, which degrades this publisher back to re-publishing every
    beat — the mixed-version stance. ``stop(deregister=True)`` deletes
    the key so consumers drop the row without waiting out the lease.
    Subclasses implement ``snapshot() -> dict``.
    """

    # Same TTL posture as the controller heartbeat: one lost beat must
    # not expire a healthy publisher, two-and-a-half do.
    LEASE_FACTOR = 2.5
    BACKOFF_MAX = 30.0
    THREAD_NAME = "oim-row-publisher"

    def __init__(
        self,
        key: str,
        registry_address: str,
        interval: float = 10.0,
        lease_seconds: float = 0.0,
        tls: TLSConfig | None = None,
        pool: channelpool.ChannelPool | None = None,
        republish_every: int = 4,
    ):
        self.key = key
        self._endpoints = RegistryEndpoints(registry_address)
        self.interval = interval
        if lease_seconds == 0.0:
            lease_seconds = self.LEASE_FACTOR * interval
        self.lease_seconds = max(lease_seconds, 0.0)
        self.tls = tls
        self._pool = pool if pool is not None else channelpool.shared()
        # Monotonic beat counter, stamped into every snapshot: it makes
        # each re-publish change the row's VALUE even when the snapshot
        # repeats, which is how consumers (router table mark_failed)
        # tell a fresh heartbeat from the frozen row of a dead
        # publisher whose lease has not lapsed yet.
        self._beats = 0
        # Batch-renewal state: every Nth beat re-publishes in full even
        # when unchanged, so a consumer's row-changed freshness check
        # (mark_failed re-admission) is bounded by N x interval, not
        # forever; <= 1 disables renewal (always publish).
        self.republish_every = max(int(republish_every), 1)
        self._renews_since_publish = 0
        self._last_body: dict | None = None  # last published, sans beat
        self._last_snapshot: dict | None = None
        # None = unknown (probe on the first renewable beat); False =
        # the registry ignored `keys` (pre-batch) — publish every beat.
        self._batch_supported: bool | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def snapshot(self) -> dict:
        """The JSON value published under ``self.key`` each beat."""
        raise NotImplementedError

    def _registry_channel(self) -> grpc.Channel:
        return self._pool.get(
            self._endpoints.current(), self.tls, "component.registry")

    def _set(self, value: str, lease_seconds: float) -> None:
        # One in-call failover hop: a write that lands on a standby /
        # quorum follower jumps to the leader its rejection named (or
        # rotates) and retries immediately — direct beat_once() callers
        # (first registration, the draining announcement) must not fail
        # just because the list's first endpoint is not the leader.
        for attempt in (0, 1):
            try:
                RegistryStub(self._registry_channel()).SetValue(
                    pb.SetValueRequest(value=pb.Value(
                        path=self.key, value=value,
                        lease_seconds=lease_seconds)),
                    timeout=10.0,
                )
                return
            except grpc.RpcError as err:
                self._pool.maybe_evict(err, self._endpoints.current())
                if (attempt == 0 and self._endpoints.multiple
                        and err.code() in FAILOVER_CODES):
                    if not self._endpoints.apply_hint(err):
                        self._endpoints.advance()
                    continue
                raise

    def beat_once(self, **overrides) -> dict:
        """One heartbeat: renew the unchanged row by batched Heartbeat
        when the registry supports it, else (or when the snapshot
        changed, or at the republish bound) publish it in full. Returns
        the row's current snapshot."""
        snap = self.snapshot()
        snap.update(overrides)
        if (self._batch_supported is not False
                and self._last_body == snap
                and self._renews_since_publish + 1 < self.republish_every
                and self._renew_once()):
            self._renews_since_publish += 1
            return self._last_snapshot
        self._beats += 1
        self._renews_since_publish = 0
        body = dict(snap)
        snap["beat"] = self._beats
        self._set(json.dumps(snap, sort_keys=True), self.lease_seconds)
        self._last_body = body
        self._last_snapshot = snap
        return snap

    def _renew_once(self) -> bool:
        """One batched lease renewal of this row. False = fall through
        to a full publish (pre-batch registry, or the registry lost the
        row). Transport/role errors raise for the loop's failover+
        backoff handling, exactly like a failed publish."""
        try:
            reply = RegistryStub(self._registry_channel()).Heartbeat(
                pb.HeartbeatRequest(
                    keys=[self.key], lease_seconds=self.lease_seconds),
                timeout=10.0,
            )
        except grpc.RpcError as err:
            if err.code() in (grpc.StatusCode.UNIMPLEMENTED,
                              grpc.StatusCode.INVALID_ARGUMENT):
                # UNIMPLEMENTED: no Heartbeat RPC at all (pre-lease
                # registry). INVALID_ARGUMENT ("empty controller_id"):
                # a pre-batch registry that parsed the request but
                # knows nothing of `keys`. Either way: publish every
                # beat, the era this publisher already handles.
                self._batch_supported = False
                return False
            self._pool.maybe_evict(err, self._endpoints.current())
            raise
        if len(reply.keys_known) != 1:
            # The registry parsed the request but ignored `keys`: a
            # pre-batch build. Degrade to publish-every-beat.
            self._batch_supported = False
            return False
        self._batch_supported = True
        # keys_known[0] False = the registry no longer holds the row
        # (restart, swept lease): re-publish in full NOW.
        return bool(reply.keys_known[0])

    def start(self) -> None:
        def loop() -> None:
            log = from_context().with_fields(row=self.key)
            # Same jittered-exponential discipline as the controller
            # heartbeat loop, via the shared common/backoff.py copy.
            backoff = ExponentialBackoff(
                base=min(1.0, self.interval), cap=self.BACKOFF_MAX)
            while not self._stop.is_set():
                try:
                    self.beat_once()
                    backoff.reset()
                    log.debug("row heartbeat",
                              registry=self._endpoints.current())
                except grpc.RpcError as err:
                    if (self._endpoints.multiple
                            and err.code() in FAILOVER_CODES):
                        if not self._endpoints.apply_hint(err):
                            self._endpoints.advance()
                        target = self._endpoints.current()
                        log.warning("failing over to peer registry",
                                    target=target)
                    delay = backoff.next()
                    log.warning(
                        "registry unreachable; backing off",
                        error=err.details() or str(err.code()),
                        attempt=backoff.failures, retry_s=round(delay, 3))
                    if self._stop.wait(delay):
                        return
                    continue
                if self._stop.wait(self.interval):
                    return

        self._thread = threading.Thread(
            target=loop, name=self.THREAD_NAME, daemon=True)
        self._thread.start()

    def stop(self, deregister: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if deregister:
            try:
                # Empty value = SetValue's delete idiom: the row vanishes
                # now instead of lingering until the lease expires.
                self._set("", 0.0)
            except grpc.RpcError:
                pass  # registry down: the lease expires the row anyway


class TelemetryRegistration(RegistryRowPublisher):
    """One daemon's ``telemetry/<id>`` row: metrics endpoint + role +
    the fleet-mergeable metrics payload (``hist``/``counters``, see
    ``metrics_snapshot``) the SLO plane folds.

    ``oimctl --top`` reads the lease-filtered ``telemetry`` prefix and
    scrapes every advertised endpoint — the cluster view needs no static
    target list, and dead daemons fall out with their lease. The
    histogram snapshots ride the SAME heartbeat (the aggregation plane
    adds zero new RPCs, per the control-off-the-data-path stance): a
    beat with new observations re-publishes, an idle daemon's unchanged
    row still batch-renews. ``collect`` overrides the payload source
    (tests, and processes whose metrics live off the DEFAULT registry);
    ``collect=None`` publishes discovery-only rows (the pre-SLO wire
    shape)."""

    THREAD_NAME = "oim-telemetry"

    def __init__(
        self,
        telemetry_id: str,
        role: str,
        metrics_endpoint: str,
        registry_address: str,
        interval: float = 10.0,
        lease_seconds: float = 0.0,
        tls: TLSConfig | None = None,
        pool: channelpool.ChannelPool | None = None,
        collect=metrics_snapshot,
    ):
        super().__init__(
            telemetry_key(telemetry_id), registry_address,
            interval=interval, lease_seconds=lease_seconds,
            tls=tls, pool=pool)
        self.telemetry_id = telemetry_id
        self.role = role
        self.metrics_endpoint = metrics_endpoint
        self.collect = collect

    def snapshot(self) -> dict:
        snap = {
            "metrics": self.metrics_endpoint,
            "role": self.role,
            "pid": os.getpid(),
        }
        if self.collect is not None:
            snap.update(self.collect())
        return snap


def telemetry_snapshot(role: str, metrics_endpoint: str,
                       beat: int = 0) -> str:
    """The serialized telemetry row value, for publishers that write the
    registry DB directly instead of dialing (the registry daemon's own
    row — it must not depend on its own gRPC liveness, and a standby
    must not dial itself just to be told FAILED_PRECONDITION)."""
    return json.dumps({
        "beat": beat,
        "metrics": metrics_endpoint,
        "pid": os.getpid(),
        "role": role,
    }, sort_keys=True)
