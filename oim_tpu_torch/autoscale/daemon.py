"""oim-autoscaler's core: ONE Watch stream on the registry root feeding
a reconcile loop that keeps the fleet at its SLOs.

This is the actuator half of the loop oim-monitor's alert rows opened
(obs/monitor.py): the monitor senses (telemetry -> burn rates ->
``alert/<name>`` rows), the autoscaler acts (``alert/`` + ``serve/``
rows -> reconcile.plan() -> ReplicaLauncher spawns/drains). Both stay
pure control-plane consumers (PAPER.md §0): no data-path endpoint is
ever scraped, every input rides the registry.

One stream, not three: alerts, serve heartbeats, and the fleet/
leadership row all live under one registry tree, so the daemon watches
the ROOT prefix and keys the cached view by path — a scale-up signal,
the boot it triggers, and the rival leader's heartbeat arrive through
the same totally-ordered delta stream. A pre-Watch registry answers
UNIMPLEMENTED and the daemon degrades to jittered GetValues polling,
monitor-style (mixed-version safe).

HA rides the registry's own lease-as-leadership pattern: whoever leads
publishes the TTL-leased ``fleet/autoscaler`` desired-state row
(``republish_every=1``, so the monotonic ``beat`` advances every
publish); a standby runs the same loops but only watches the row,
deferring while the leader's beat progresses and claiming the key once
it freezes or the lease lapses (reconcile.LeaderGate — a replayed
frozen row can never be re-admitted as fresh). On takeover the new
leader ADOPTS the dead leader's published target before planning, so a
mid-incident failover never drains the capacity the incident just
added. A dead autoscaler is therefore visible (its row expires) and a
second one is safe to run hot.
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
from oim_tpu_torch.common.pathutil import (
    REGISTRY_ALERT,
    REGISTRY_FLEET,
    REGISTRY_SERVE,
)
from oim_tpu_torch.common.telemetry import RegistryRowPublisher
from oim_tpu_torch.common.tlsutil import TLSConfig
from oim_tpu_torch.autoscale.launcher import ReplicaLauncher
from oim_tpu_torch.autoscale.reconcile import (
    FleetSpec,
    LeaderGate,
    ObservedReplica,
    ReconcileState,
    plan,
)
from oim_tpu_torch.router.table import Replica
from oim_tpu_torch.spec import oim_pb2 as pb
from oim_tpu_torch.spec.services import RegistryStub

# The one well-known desired-state key: leadership is ownership of this
# row, so every autoscaler (leader or standby) names the same key.
FLEET_ROW = "autoscaler"


def fleet_key(name: str) -> str:
    if not name or "/" in name:
        raise ValueError(f"fleet row name must be a single path "
                         f"component, got {name!r}")
    return f"{REGISTRY_FLEET}/{name}"


class _FleetRow(RegistryRowPublisher):
    """The leader's TTL-leased desired-state row. ``republish_every=1``:
    every beat PUBLISHES (never batch-renews), so the monotonic ``beat``
    stamp advances while the leader lives — the exact signal a
    standby's LeaderGate requires, and the fix for a renewal freezing
    the last snapshot for a full lease window."""

    THREAD_NAME = "oim-fleet-row"

    def __init__(self, status_fn, registry_address: str, interval: float,
                 tls: TLSConfig | None, pool: channelpool.ChannelPool | None):
        super().__init__(fleet_key(FLEET_ROW), registry_address,
                         interval=interval, tls=tls, pool=pool,
                         republish_every=1)
        self._status_fn = status_fn

    def snapshot(self) -> dict:
        return self._status_fn()


class Autoscaler:
    """Watch-fed fleet view + the reconcile tick. ``start()`` runs the
    loops in daemon threads; ``tick_once()`` is the unit the loop (and
    tests, with an injected clock) drive."""

    def __init__(
        self,
        registry_address: str,
        spec: FleetSpec,
        launcher: ReplicaLauncher,
        autoscaler_id: str = "autoscaler",
        interval: float = 5.0,
        tls: TLSConfig | None = None,
        pool: channelpool.ChannelPool | None = None,
        watch: bool = True,
        stale_after_s: float | None = None,
        pending_timeout_s: float = 300.0,
    ):
        self.registry_address = registry_address
        self.spec = spec
        self.launcher = launcher
        self.autoscaler_id = autoscaler_id
        self.interval = interval
        self.tls = tls
        self._endpoints = RegistryEndpoints(registry_address)
        self._pool = pool if pool is not None else channelpool.shared()
        self.watch_enabled = watch
        # How long a rival's fleet row may sit with a frozen beat before
        # this standby claims leadership: just past the row's lease, so
        # a clean expiry (pushed by Watch) usually wins the race and the
        # beat check remains the backstop against replayed stale rows.
        self.stale_after_s = (
            RegistryRowPublisher.LEASE_FACTOR * interval + interval
            if stale_after_s is None else stale_after_s)
        # A spawn the registry never echoed back (launcher died, boot
        # wedged) stops counting toward the fleet after this long, so
        # the reconciler repairs instead of waiting forever.
        self.pending_timeout_s = pending_timeout_s
        self._gate = LeaderGate(autoscaler_id, self.stale_after_s)
        self._state = ReconcileState()
        self._pending: dict[str, tuple[float, str]] = {}  # rid -> (at, ver)
        self._last_row: dict | None = None  # last seen fleet row (any owner)
        self._alert_t0: float | None = None
        self._alert_spawned = False
        self._row: _FleetRow | None = None
        self._status_body: dict = {}
        self._view: dict[str, str] = {}
        self._lock = threading.Lock()
        self._resume_token = ""
        self._watch_call = None
        self._watch_synced = False
        self._stop = threading.Event()
        self._watch_thread: threading.Thread | None = None
        self._tick_thread: threading.Thread | None = None

    # -- the fleet view (one stream on the registry root) ------------------

    def _stub(self) -> RegistryStub:
        return RegistryStub(self._pool.get(
            self._endpoints.current(), self.tls, "component.registry"))

    def poll_once(self) -> None:
        """One GetValues sweep of the whole tree (the mixed-version
        fallback, and the resync belt while the stream is not synced).
        Raises grpc.RpcError after rotating the endpoint cursor."""
        address = self._endpoints.current()
        try:
            reply = self._stub().GetValues(
                pb.GetValuesRequest(path=""), timeout=10.0)
        except grpc.RpcError as err:
            self._pool.maybe_evict(err, address)
            if self._endpoints.multiple and err.code() in FAILOVER_CODES \
                    and not self._endpoints.apply_hint(err):
                self._endpoints.advance()
            raise
        with self._lock:
            self._view = {v.path: v.value for v in reply.values}

    def _watch_once(self) -> None:
        from oim_tpu_torch.registry.watch import WatchConsumer

        address = self._endpoints.current()
        stub = self._stub()
        consumer = WatchConsumer()
        consumer.resume_token = self._resume_token

        def install(rows: dict) -> None:
            with self._lock:
                self._view = dict(rows)

        def put(path: str, value: str) -> None:
            with self._lock:
                self._view[path] = value

        def delete(path: str, expired: bool) -> None:
            # Expiry and deletion read the same here: a lease-lapsed
            # serve row is a dead replica, a lapsed alert row is a dead
            # monitor's stale alarm, and a lapsed fleet row is the
            # takeover signal.
            with self._lock:
                self._view.pop(path, None)

        def on_sync() -> None:
            self._watch_synced = True

        def on_reset() -> None:
            self._watch_synced = False

        try:
            call = stub.Watch(pb.WatchRequest(
                path="", resume_token=self._resume_token))
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
                                consumer="autoscaler",
                                reason="pre-watch registry: poll mode")
                    log.warning(
                        "registry has no Watch RPC; oim-autoscaler "
                        "degrades to GetValues polling")
                    return
                delay = backoff.next()
                log.debug("fleet watch stream failed; backing off",
                          registry=self._endpoints.current(),
                          error=err.code().name, retry_s=round(delay, 2))
            if self._stop.wait(delay):
                return

    @staticmethod
    def _body(value: str) -> dict | None:
        try:
            body = json.loads(value)
        except ValueError:
            return None
        return body if isinstance(body, dict) else None

    def _observe(self, view: dict, now: float) -> list[ObservedReplica]:
        """serve/ rows + pending launches -> the reconciler's fleet
        view. Parsing rides the router's own Replica.parse, so the
        autoscaler and the router can never disagree about what a row
        means (including mixed-version rows with no ``version`` key)."""
        observed = []
        for path, value in view.items():
            if not path.startswith(REGISTRY_SERVE + "/"):
                continue
            replica = Replica.parse(path, value)
            if replica is None:
                # ready:false rows still parse; only garbage is None —
                # and a row the router can't route shouldn't count as
                # fleet capacity either.
                continue
            self._pending.pop(replica.replica_id, None)
            observed.append(ObservedReplica(
                replica_id=replica.replica_id,
                ready=replica.ready,
                version=replica.version,
                score=replica.queue_depth - replica.free_slots,
            ))
        seen = {o.replica_id for o in observed}
        for rid, (at, version) in list(self._pending.items()):
            if rid in seen:
                del self._pending[rid]
            elif now - at > self.pending_timeout_s:
                del self._pending[rid]
                from_context().warning(
                    "pending spawn never registered", replica=rid,
                    waited_s=round(now - at, 1))
            else:
                # A launch in flight counts as a not-ready replica, so
                # re-planning during a boot never spawns it twice
                # (reconcile.py's caller contract).
                observed.append(ObservedReplica(
                    replica_id=rid, ready=False, version=version))
        return observed

    # -- the reconcile tick ------------------------------------------------

    def set_spec(self, spec: FleetSpec) -> None:
        """Swap the declared fleet (new bounds, or a new weights version
        to start a rolling upgrade wave). Takes effect next tick."""
        self.spec = spec

    @property
    def is_leader(self) -> bool:
        return self._gate.leading

    def tick_once(self, now: float | None = None) -> dict:
        """One reconcile step. ``now`` injects the clock for tests (the
        loop passes None = time.monotonic()); returns a summary dict."""
        now = time.monotonic() if now is None else now
        if not self._watch_synced:
            try:
                self.poll_once()
            except grpc.RpcError:
                pass  # plan on the cached view; backoff next tick
        with self._lock:
            view = dict(self._view)
        row = self._body(view.get(fleet_key(FLEET_ROW), ""))
        if row is not None:
            self._last_row = row
        was_leader = self._gate.leading
        if not self._gate.observe(row, now):
            return {"leader": False, "target": None, "ready": None,
                    "actions": []}
        if not was_leader:
            self._adopt_target()
            events.emit(events.AUTOSCALE_TAKEOVER,
                        autoscaler=self.autoscaler_id,
                        adopted_target=self._state.target)
            from_context().info("took fleet leadership",
                                autoscaler=self.autoscaler_id,
                                adopted_target=self._state.target)

        observed = self._observe(view, now)
        alerts = {}
        for path, value in view.items():
            if path.startswith(REGISTRY_ALERT + "/"):
                name = path.partition("/")[2]
                body = self._body(value)
                alerts[name] = body if body is not None else {}
        actions, self._state = plan(
            self.spec, observed, alerts, now, self._state)
        # Stamp the episode start BEFORE executing: the first firing
        # tick usually also carries the spawn, and _execute sets the
        # spawned flag this stamp must not clobber.
        if alerts and self._alert_t0 is None:
            self._alert_t0 = now
            self._alert_spawned = False
        self._execute(actions, now)
        ready = sum(1 for o in observed if o.ready)
        self._track_alert_to_ready(alerts, ready, now)
        M.AUTOSCALE_REPLICAS_DESIRED.set(self._state.target)
        M.AUTOSCALE_REPLICAS_READY.set(ready)
        self._publish_row(alerts, ready)
        return {"leader": True, "target": self._state.target,
                "ready": ready, "actions": actions}

    def _adopt_target(self) -> None:
        """On takeover, seed the reconcile target from the last leader's
        published desired-state — a mid-incident failover must continue
        the scale-up it inherited, not drain it back to min first."""
        if self._state.target >= 0 or self._last_row is None:
            return
        desired = self._last_row.get("desired")
        if isinstance(desired, int) and desired >= 0:
            self._state = dataclasses.replace(self._state, target=desired)

    def _execute(self, actions, now: float) -> None:
        log = from_context()
        for action in actions:
            try:
                if action.kind == "spawn":
                    rid = self.launcher.spawn(action.version)
                    self._pending[rid] = (now, action.version)
                    M.AUTOSCALE_ACTIONS_TOTAL.labels(action="spawn").inc()
                    events.emit(events.AUTOSCALE_SCALE_UP, replica=rid,
                                reason=action.reason,
                                target=self._state.target)
                    if action.reason.startswith("alert:"):
                        self._alert_spawned = True
                    log.info("scale up", replica=rid, reason=action.reason,
                             target=self._state.target)
                elif action.kind == "drain":
                    self.launcher.drain(action.replica_id)
                    M.AUTOSCALE_ACTIONS_TOTAL.labels(action="drain").inc()
                    events.emit(events.AUTOSCALE_SCALE_DOWN,
                                replica=action.replica_id,
                                reason=action.reason,
                                target=self._state.target)
                    if action.reason == "upgrade":
                        events.emit(events.AUTOSCALE_UPGRADE_FLIP,
                                    replica=action.replica_id,
                                    version=self.spec.version)
                    log.info("scale down", replica=action.replica_id,
                             reason=action.reason,
                             target=self._state.target)
            except Exception as err:  # noqa: BLE001 - one failed actuation
                # must not abort the rest of the plan (or the tick loop)
                log.warning("launcher action failed", kind=action.kind,
                            replica=action.replica_id, error=repr(err))

    def _track_alert_to_ready(self, alerts, ready: int,
                              now: float) -> None:
        """alert/ row first observed -> the raised target fully ready:
        the histogram bench.py --autoscale breaks down."""
        if self._alert_t0 is not None and self._alert_spawned \
                and ready >= self._state.target > 0:
            M.AUTOSCALE_ALERT_TO_READY.observe(now - self._alert_t0)
            self._alert_t0, self._alert_spawned = None, False
        if not alerts and not self._alert_spawned:
            self._alert_t0 = None

    def _publish_row(self, alerts, ready: int) -> None:
        if self._row is None:
            self._row = _FleetRow(
                self._status, self.registry_address, self.interval,
                self.tls, self._pool)
        self._status_body = {
            "autoscaler": self.autoscaler_id,
            "desired": self._state.target,
            "ready": ready,
            "min": self.spec.min_replicas,
            "max": self.spec.max_replicas,
            "version": self.spec.version,
            "alerts": sorted(alerts),
        }
        try:
            self._row.beat_once()
        except grpc.RpcError as err:
            from_context().warning("fleet row publish failed",
                                   error=err.code().name)

    def _status(self) -> dict:
        return dict(self._status_body)

    def _tick_loop(self) -> None:
        while not self._stop.wait(jittered(self.interval)):
            try:
                self.tick_once()
            except Exception as err:  # noqa: BLE001 - the actuator must
                from_context().warning(  # survive anything a tick throws
                    "reconcile tick failed", error=repr(err))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self.watch_enabled:
            self._watch_thread = threading.Thread(
                target=self._watch_loop, name="oim-autoscaler-watch",
                daemon=True)
            self._watch_thread.start()
        self._tick_thread = threading.Thread(
            target=self._tick_loop, name="oim-autoscaler-tick", daemon=True)
        self._tick_thread.start()

    def stop(self, deregister: bool = True) -> None:
        """``deregister=True`` deletes the fleet row (clean handoff: a
        standby promotes on the pushed delete, no lease to wait out);
        ``deregister=False`` abandons it frozen — crash semantics, the
        path the chaos ladder kills a leader through."""
        self._stop.set()
        call = self._watch_call
        if call is not None:
            call.cancel()
        for attr in ("_watch_thread", "_tick_thread"):
            thread = getattr(self, attr)
            if thread is not None:
                thread.join(timeout=5.0)
                setattr(self, attr, None)
        if self._row is not None:
            self._row.stop(deregister=deregister and self._gate.leading)
            self._row = None
