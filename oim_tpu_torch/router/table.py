"""The router's replica table: a lease-filtered cached view of the
registry's ``serve/<id>`` rows.

Routing decisions must stay off the control plane's hot path (OIM's
premise: control traffic is short-lived and infrequent). The table is
PUSH-fed by default: one ``Watch("serve")`` stream delivers row deltas
the moment they commit — a replica drain, re-register, or lease expiry
reaches the routing view in one event instead of waiting out a poll
tick, and a ``mark_failed`` replica re-admits the moment its row
CHANGES (a fresh heartbeat re-publish) rather than at the next poll.
The GetValues poll survives as the mixed-version and resync fallback:
against a pre-Watch registry (UNIMPLEMENTED) the table degrades to the
original jittered poll transparently, and while a watch stream is live
the poll idles unless the cached view goes silent (a black-holed stream
must not wedge the table — the poll thread cancels it and re-resolves).

Liveness comes for free either way: the registry's lease filter (poll)
or pushed EXPIRED deletions (watch) hide replicas that stopped
heartbeating, and a draining replica publishes ``ready: false``
(serve/registration.py), which the table treats as absent.

Registry outages degrade gracefully, feeder-style: endpoint rotation on
UNAVAILABLE / FAILED_PRECONDITION (replicated pair or quorum, with the
follower's ``leader=`` hint fast-pathing the cursor), pooled channels
with transport-failure eviction, and the last good snapshot keeps
serving until ``max_stale`` — a registry blip must not take the whole
serving tier down with it.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time

import grpc

from oim_tpu_torch.common import channelpool, events, metrics as M
from oim_tpu_torch.common.backoff import ExponentialBackoff, jittered
from oim_tpu_torch.common.endpoints import FAILOVER_CODES, RegistryEndpoints
from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.common.tlsutil import TLSConfig
# The serve/<id> namespace constant, via pathutil rather than the serve
# package: the router daemon routes bytes, it never imports the model
# stack (oim_tpu_torch.serve.__init__ pulls in jax).
from oim_tpu_torch.common.pathutil import REGISTRY_SERVE as SERVE_PREFIX
from oim_tpu_torch.spec import oim_pb2 as pb
from oim_tpu_torch.spec.services import RegistryStub


@dataclasses.dataclass(frozen=True)
class Replica:
    """One live serve replica, as advertised by its last heartbeat."""

    replica_id: str
    endpoint: str
    free_slots: int = 0
    queue_depth: int = 0
    max_batch: int = 0
    ready: bool = True
    # Prefix-cache advertisement (serve/registration.py): the replica's
    # hot chain hashes and the block size they were hashed at. Empty /
    # 0 for replicas that predate the prefix cache (or run with it
    # disabled) — they stay routable, just never attract affinity.
    prefix_block: int = 0
    prefix_hashes: frozenset = frozenset()
    # KV-tier advertisement (serve/kvtier.py): chain hashes the replica
    # holds DEMOTED in host RAM (a hit there pays an H2D re-stage, so
    # the affinity pick prefers an HBM holder at equal depth), and the
    # deepest hashes of chains it exported as content-addressed volumes
    # (fetchable by any peer). Both empty for pre-tier replicas — the
    # advertisement parse is tolerant exactly like the prefix one: a
    # malformed tier map only disables tier awareness, never routing.
    prefix_hosted: frozenset = frozenset()
    prefix_volumes: frozenset = frozenset()
    # Weights-version advertisement (rolling upgrades): "" for replicas
    # that predate the field or run unversioned. The router only uses it
    # as a soft retry preference — a version is never a routability
    # filter, so a mixed-version fleet keeps every row in play.
    version: str = ""
    # Disaggregation role (prefill | decode | mixed). Missing or
    # malformed reads "mixed": a role-less row from a pre-role replica
    # routes exactly as today, so a mixed-version fleet never strands
    # traffic on a parse difference.
    role: str = "mixed"

    @classmethod
    def parse(cls, path: str, value: str) -> "Replica | None":
        """A ``serve/<id>`` row -> Replica; None for rows that cannot
        route (malformed JSON, missing endpoint, non-numeric load
        fields) — a bad registration must not crash the table (or the
        poll thread above it), just not receive traffic. A malformed
        prefix advertisement only disables affinity for the replica
        (the load fields still route it)."""
        parts = path.split("/")
        if len(parts) != 2:
            return None
        try:
            snap = json.loads(value)
        except ValueError:
            return None
        if not isinstance(snap, dict) or not snap.get("endpoint"):
            return None
        try:
            block = int(snap.get("prefix_block", 0))
            hashes = snap.get("prefix_hashes", ())
            if block < 1 or not isinstance(hashes, (list, tuple)) \
                    or not all(isinstance(h, str) for h in hashes):
                block, hashes = 0, ()
        except (TypeError, ValueError):
            block, hashes = 0, ()
        # The tiered advertisement (prefix_tiers: hash -> "hbm"|"host",
        # prefix_volumes: deepest hash -> volume id). A new-router x
        # old-replica row simply lacks the keys; a malformed map from
        # a buggy replica degrades to the flat hash set above.
        hosted: tuple = ()
        volumes: tuple = ()
        tier_map = snap.get("prefix_tiers")
        if isinstance(tier_map, dict) and block >= 1 and all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in tier_map.items()):
            hosted = tuple(
                k for k, v in tier_map.items() if v == "host")
            if not hashes:
                # A tier map can carry the whole advertisement; keep
                # the flat set populated so pre-tier affinity logic
                # (and mixed rows) sees the HBM chains either way.
                hashes = tuple(
                    k for k, v in tier_map.items() if v == "hbm")
        vol_map = snap.get("prefix_volumes")
        if isinstance(vol_map, dict) and all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in vol_map.items()):
            volumes = tuple(vol_map.keys())
        role = snap.get("role")
        if role not in ("prefill", "decode", "mixed"):
            role = "mixed"
        try:
            return cls(
                replica_id=parts[1],
                endpoint=str(snap["endpoint"]),
                free_slots=int(snap.get("free_slots", 0)),
                queue_depth=int(snap.get("queue_depth", 0)),
                max_batch=int(snap.get("max_batch", 0)),
                ready=bool(snap.get("ready", True)),
                prefix_block=block,
                prefix_hashes=frozenset(hashes),
                prefix_hosted=frozenset(hosted),
                prefix_volumes=frozenset(volumes),
                version=(snap["version"]
                         if isinstance(snap.get("version"), str) else ""),
                role=role,
            )
        except (TypeError, ValueError):
            return None


class ReplicaTable:
    """Thread-safe cached replica set with a background jittered poll."""

    def __init__(
        self,
        registry_address: str,
        interval: float = 2.0,
        max_stale: float = 30.0,
        tls: TLSConfig | None = None,
        pool: channelpool.ChannelPool | None = None,
        watch: bool = True,
    ):
        self._endpoints = RegistryEndpoints(registry_address)
        self.interval = interval
        # Push invalidation (Watch stream) with the poll as fallback;
        # False = the pre-Watch pure-poll behavior (bench comparisons,
        # conservative deployments).
        self.watch_enabled = watch
        # How long the last good snapshot keeps serving through a
        # registry outage before the table reports itself empty: bounded
        # by how stale a routing decision may be — replicas that died in
        # the window fail over on the data path anyway.
        self.max_stale = max_stale
        self.tls = tls
        self._pool = pool if pool is not None else channelpool.shared()
        self._replicas: dict[str, Replica] = {}
        # Raw row value per replica id, as of the last refresh: the
        # freshness token for _failed below (every heartbeat re-publish
        # changes the value — registration stamps a beat counter).
        self._raw: dict[str, str] = {}
        self._refreshed_at = 0.0
        # Data-path verdicts overlaid between polls: replica id -> the
        # raw row value at the moment of failure. A later poll clears
        # the mark only when the row's value has CHANGED (the replica
        # heartbeat again — it is alive) or the row is gone (lease
        # lapsed). Merely re-reading the frozen row of a freshly-killed
        # replica proves nothing: its lease outlives it by design, and
        # re-admitting it would point most picks at a corpse for the
        # whole lease window.
        self._failed: dict[str, str | None] = {}
        # True while the cached snapshot has aged past max_stale: the
        # table is serving NOTHING. Guarded by _lock; the transition
        # (not the steady state) emits the flight-recorder event — a
        # router refusing picks must be visible in /debug/events, not
        # only as client UNAVAILABLEs.
        self._stale = False
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._watch_thread: threading.Thread | None = None
        # Watch-stream state: the in-flight call (cancellable by stop()
        # and by the poll thread's silence guard), the resume token of
        # the last delivered event, and whether a stream is attached
        # AND synced (the poll idles only then).
        self._watch_call = None
        self._watch_synced = False
        self._resume_token = ""
        # A stream that goes silent longer than this is presumed
        # black-holed: the poll thread cancels it and refreshes. The
        # hub keepalives every ~2s, so silence means a dead transport.
        self._watch_silence = max(4 * interval, 8.0)

    # -- refresh ----------------------------------------------------------

    def refresh(self) -> None:
        """One GetValues poll: replace the cached replica set with the
        registry's lease-filtered view. Raises grpc.RpcError on failure
        (after rotating the endpoint cursor, feeder-style)."""
        address = self._endpoints.current()
        try:
            reply = RegistryStub(self._pool.get(
                address, self.tls, "component.registry")).GetValues(
                pb.GetValuesRequest(path=SERVE_PREFIX), timeout=10.0)
        except grpc.RpcError as err:
            self._pool.maybe_evict(err, address)
            if self._endpoints.multiple and err.code() in FAILOVER_CODES \
                    and not self._endpoints.apply_hint(err):
                self._endpoints.advance()
            raise
        fresh = {}
        raw = {}
        for value in reply.values:
            replica = Replica.parse(value.path, value.value)
            if replica is not None and replica.ready:
                fresh[replica.replica_id] = replica
                raw[replica.replica_id] = value.value
        self._install(fresh, raw)

    def _install(self, fresh: dict, raw: dict) -> None:
        """Replace the cached replica set with a complete snapshot (a
        GetValues poll, or a Watch RESET..SYNC rebuild)."""
        with self._lock:
            self._replicas = fresh
            self._raw = raw
            self._refreshed_at = time.monotonic()
            # Keep a failure mark only while the failed row is still
            # byte-identical (no heartbeat since the failure) — a
            # changed or vanished row clears it.
            self._failed = {
                rid: val for rid, val in self._failed.items()
                if rid in raw and raw[rid] == val
            }
            count = sum(1 for rid in fresh if rid not in self._failed)
            recovered, self._stale = self._stale, False
            # Gauge + recovery event inside the lock: a concurrent
            # replicas() entering stale mode serializes against this,
            # so the flight recorder can never show recovered-before-
            # stale and the gauge never reads a stale 0 after a fresh
            # snapshot (emit is one deque append — cheap under a lock).
            M.ROUTER_REPLICAS.set(count)
            if recovered:
                events.emit(events.ROUTER_TABLE_RECOVERED, replicas=count)

    def _apply_delta(self, rid: str, value: str | None) -> None:
        """Patch one replica row from a Watch delta. ``None`` = the row
        was deleted or its lease expired."""
        with self._lock:
            if value is None:
                self._replicas.pop(rid, None)
                self._raw.pop(rid, None)
                self._failed.pop(rid, None)
            else:
                if rid in self._failed and self._failed[rid] != value:
                    # The row CHANGED: the replica heartbeat again —
                    # instant re-admission, no poll tick to wait out.
                    del self._failed[rid]
                replica = Replica.parse(f"{SERVE_PREFIX}/{rid}", value)
                if replica is not None and replica.ready:
                    self._replicas[rid] = replica
                    self._raw[rid] = value
                else:
                    # Draining (ready: false) or unparseable: absent
                    # from the routable set, same as the poll filter.
                    self._replicas.pop(rid, None)
                    self._raw.pop(rid, None)
            self._refreshed_at = time.monotonic()
            # A delta only arrives on a live, synced stream: the view
            # is complete again, so a stale episode ends here.
            count = sum(1 for r in self._replicas
                        if r not in self._failed)
            recovered, self._stale = self._stale, False
            M.ROUTER_REPLICAS.set(count)
            if recovered:
                events.emit(events.ROUTER_TABLE_RECOVERED, replicas=count)

    # -- the Watch stream --------------------------------------------------

    def _watch_once(self) -> None:
        """One Watch-stream lifetime: open (resuming from the last
        token when the server still retains it), rebuild on RESET..SYNC,
        patch deltas in place after — the shared ``WatchConsumer``
        state machine owns the reset batching and token discipline.
        Returns when the stream ends; raises grpc.RpcError on failure
        (including UNIMPLEMENTED from a pre-Watch registry — the
        caller's degrade signal)."""
        from oim_tpu_torch.registry.watch import WatchConsumer

        address = self._endpoints.current()
        stub = RegistryStub(self._pool.get(
            address, self.tls, "component.registry"))
        consumer = WatchConsumer()
        consumer.resume_token = self._resume_token

        def rid_of(path: str) -> str | None:
            parts = path.split("/")
            return parts[1] if len(parts) == 2 else None

        def install(rows: dict) -> None:
            fresh, raw = {}, {}
            for path, value in rows.items():
                rid = rid_of(path)
                replica = Replica.parse(path, value)
                if rid and replica is not None and replica.ready:
                    fresh[rid] = replica
                    raw[rid] = value
            self._install(fresh, raw)

        def put(path: str, value: str) -> None:
            rid = rid_of(path)
            if rid:
                self._apply_delta(rid, value)

        def delete(path: str, expired: bool) -> None:
            rid = rid_of(path)
            if rid:
                self._apply_delta(rid, None)

        def on_sync() -> None:
            with self._lock:
                self._refreshed_at = time.monotonic()
            self._watch_synced = True

        def on_reset() -> None:
            self._watch_synced = False

        try:
            call = stub.Watch(pb.WatchRequest(
                path=SERVE_PREFIX, resume_token=self._resume_token))
            self._watch_call = call
            consumer.run(call, install=install, put=put, delete=delete,
                         on_reset=on_reset, on_sync=on_sync,
                         is_stopped=self._stop.is_set)
        except grpc.RpcError as err:
            self._pool.maybe_evict(err, address)
            if self._endpoints.multiple and err.code() in FAILOVER_CODES \
                    and not self._endpoints.apply_hint(err):
                self._endpoints.advance()
            raise
        finally:
            self._resume_token = consumer.resume_token
            self._watch_call = None
            self._watch_synced = False

    def _watch_loop(self) -> None:
        """Retry Watch streams forever; one UNIMPLEMENTED (pre-Watch
        registry) retires this thread and leaves the poll in charge."""
        log = from_context()
        backoff = ExponentialBackoff(
            base=max(self.interval / 2, 0.05), cap=10.0)
        while not self._stop.is_set():
            try:
                self._watch_once()
                backoff.reset()
                delay = jittered(max(self.interval / 2, 0.05))
            except grpc.RpcError as err:
                if err.code() == grpc.StatusCode.UNIMPLEMENTED:
                    events.emit(events.WATCH_RESYNC,
                                consumer="router_table",
                                reason="pre-watch registry: poll mode")
                    log.warning(
                        "registry has no Watch RPC; replica table "
                        "degrades to GetValues polling")
                    return
                delay = backoff.next()
                log.debug("replica watch stream failed; backing off",
                          registry=self._endpoints.current(),
                          error=err.code().name,
                          retry_s=round(delay, 2))
            if self._stop.wait(delay):
                return

    def _watch_live(self) -> bool:
        """A synced stream delivered something recently: the poll can
        idle. Silence past the guard presumes a black-holed transport —
        cancel the stream so the watch loop re-dials."""
        call = self._watch_call
        if call is None or not self._watch_synced:
            return False
        with self._lock:
            age = time.monotonic() - self._refreshed_at
        if age > self._watch_silence:
            call.cancel()
            return False
        return True

    def _refresh_if_due(self) -> None:
        with self._lock:
            due = time.monotonic() - self._refreshed_at >= self.interval
        if due:
            try:
                self.refresh()
            except grpc.RpcError:
                pass  # serve the cached view until max_stale

    # -- the routing view -------------------------------------------------

    def replicas(self) -> list[Replica]:
        """The current routable set: cached rows minus data-path
        failures, empty once the cache ages past ``max_stale``. Refreshes
        inline when the poll thread isn't running (tests, one-shot use)
        or has fallen behind."""
        if self._thread is None:
            self._refresh_if_due()
        with self._lock:
            age = time.monotonic() - self._refreshed_at
            if self._refreshed_at and age <= self.max_stale:
                return [r for r in self._replicas.values()
                        if r.replica_id not in self._failed]
            # A table that never refreshed is EMPTY, not stale: no
            # snapshot existed to age out, and a boot-race pick must
            # not stamp the recorder with age_s = the host's monotonic
            # uptime (the poll thread's first refresh is in flight).
            if self._refreshed_at:
                entered, self._stale = not self._stale, True
                if entered:  # once per episode
                    M.ROUTER_REPLICAS.set(0)
                    events.emit(events.ROUTER_TABLE_STALE,
                                age_s=round(age, 3),
                                max_stale_s=self.max_stale)
        return []

    def mark_failed(self, replica_id: str) -> None:
        """Data-path verdict: drop ``replica_id`` from the routable set
        until a later poll proves it alive again — "proves" meaning its
        ROW CHANGED (a fresh heartbeat re-publish), not merely that its
        frozen lease is still ticking."""
        with self._lock:
            self._failed[replica_id] = self._raw.get(replica_id)
            # During a stale episode the routable set is EMPTY whatever
            # the expired snapshot says — the gauge and the event must
            # not resurrect a positive count replicas() is refusing.
            count = 0 if self._stale else sum(
                1 for r in self._replicas.values()
                if r.replica_id not in self._failed)
            # Same in-lock discipline as refresh(): a gauge set that
            # escapes the lock can overwrite a concurrent fresh
            # snapshot's count with this stale one.
            M.ROUTER_REPLICAS.set(count)
            events.emit(events.ROUTER_MARK_FAILED, replica=replica_id,
                        routable=count)

    def __len__(self) -> int:
        return len(self.replicas())

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        """Begin the background feeds: the Watch stream (push) and the
        jittered poll, which idles while a synced stream is live and
        carries the table alone against a pre-Watch registry."""
        def loop() -> None:
            log = from_context()
            # Shared backoff discipline (common/backoff.py): jitter
            # spreads a router fleet's polls so the registry never sees
            # them in lockstep, failures back off exponentially.
            backoff = ExponentialBackoff(base=self.interval, cap=30.0)
            while not self._stop.is_set():
                if self._watch_live():
                    # Push is carrying the table: skip the poll tick
                    # (this is the GetValues load the Watch removes).
                    if self._stop.wait(jittered(self.interval)):
                        return
                    continue
                try:
                    self.refresh()
                    backoff.reset()
                    delay = jittered(self.interval)
                except grpc.RpcError as err:
                    # Hard 30s ceiling AFTER jitter: the poll is how a
                    # stale (refuse-all-picks) table notices the
                    # registry is back, so its worst-case gap must not
                    # exceed the default --max-stale window.
                    delay = min(backoff.next(), 30.0)
                    log.warning(
                        "replica table refresh failed",
                        registry=self._endpoints.current(),
                        error=err.code().name, attempt=backoff.failures)
                if self._stop.wait(delay):
                    return

        self._thread = threading.Thread(
            target=loop, name="oim-router-table", daemon=True)
        self._thread.start()
        if self.watch_enabled:
            self._watch_thread = threading.Thread(
                target=self._watch_loop, name="oim-router-watch",
                daemon=True)
            self._watch_thread.start()

    def stop(self) -> None:
        self._stop.set()
        call = self._watch_call
        if call is not None:
            call.cancel()
        for attr in ("_thread", "_watch_thread"):
            thread = getattr(self, attr)
            if thread is not None:
                thread.join(timeout=5.0)
                setattr(self, attr, None)
