"""oim-monitor's core: one Watch stream on ``telemetry/`` feeding the
SLO engine, firing alerts as TTL-leased ``alert/<name>`` registry rows.

The monitor is a pure control-plane consumer (PAPER.md §0 stance): it
never scrapes a data-path endpoint. Replicas already publish mergeable
histogram snapshots inside their telemetry-row heartbeats; the monitor
rides ONE server-streaming ``Watch("telemetry")`` on the registry (the
router-table pattern from PR 14), folds every row into the fleet view,
evaluates the declared SLOs on a fixed tick, and mirrors firing
episodes into ``alert/<name>`` rows:

* fired  -> SetValue of the alert body with a lease, re-published every
  tick while firing (the lease makes a dead monitor's alerts expire);
* resolved -> the row is deleted (empty-value idiom) so consumers drop
  it immediately instead of waiting out the lease.

Alert rows are the exact input the future autoscaler consumes (ROADMAP
item 4): "first_token_p99 is firing" is a scale-up signal with no
scrape fan-out anywhere.

Mixed versions degrade per PR 14's pattern: a pre-Watch registry
answers UNIMPLEMENTED, the watch thread retires, and a jittered
GetValues poll carries the telemetry view alone. Lease-expired rows
keep their last contribution frozen in the merge (history happened);
only an explicit row DELETE forgets the replica.
"""

from __future__ import annotations

import threading

import grpc

from oim_tpu_torch.common import channelpool, events
from oim_tpu_torch.common.backoff import ExponentialBackoff, jittered
from oim_tpu_torch.common.endpoints import FAILOVER_CODES, RegistryEndpoints
from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.common.pathutil import REGISTRY_ALERT, REGISTRY_TELEMETRY
from oim_tpu_torch.common.telemetry import RegistryRowPublisher
from oim_tpu_torch.common.tlsutil import TLSConfig
from oim_tpu_torch.obs.slo import SloEngine
from oim_tpu_torch.spec import oim_pb2 as pb
from oim_tpu_torch.spec.services import RegistryStub


def alert_key(name: str) -> str:
    if not name or "/" in name:
        raise ValueError(f"alert name must be a single path component, "
                         f"got {name!r}")
    return f"{REGISTRY_ALERT}/{name}"


class _AlertRow(RegistryRowPublisher):
    """One firing alert's TTL-leased registry row; the snapshot is the
    engine's live status body, so every re-publish refreshes the burn
    numbers along with the lease."""

    THREAD_NAME = "oim-alert-row"

    def __init__(self, name: str, status_fn, registry_address: str,
                 interval: float, tls: TLSConfig | None,
                 pool: channelpool.ChannelPool | None):
        super().__init__(alert_key(name), registry_address,
                         interval=interval, tls=tls, pool=pool,
                         republish_every=1)
        self._status_fn = status_fn

    def snapshot(self) -> dict:
        return self._status_fn()


class FleetMonitor:
    """Watch-fed telemetry ingestion + periodic SLO evaluation + alert
    row publication. ``start()`` runs the loops in daemon threads;
    ``tick_once()`` is the unit the loop (and tests/bench) drive."""

    def __init__(
        self,
        registry_address: str,
        engine: SloEngine | None = None,
        interval: float = 5.0,
        monitor_id: str = "monitor",
        tls: TLSConfig | None = None,
        pool: channelpool.ChannelPool | None = None,
        watch: bool = True,
    ):
        self.engine = engine if engine is not None else SloEngine()
        self.registry_address = registry_address
        self.interval = interval
        self.monitor_id = monitor_id
        self.tls = tls
        self._endpoints = RegistryEndpoints(registry_address)
        self._pool = pool if pool is not None else channelpool.shared()
        self.watch_enabled = watch
        # Engine access is serialized: ingest arrives on the watch
        # thread, evaluate on the tick loop (or a test caller).
        self._lock = threading.Lock()
        self._alert_rows: dict[str, _AlertRow] = {}
        self._resume_token = ""
        self._watch_call = None
        self._watch_synced = False
        self._stop = threading.Event()
        self._watch_thread: threading.Thread | None = None
        self._tick_thread: threading.Thread | None = None

    # -- telemetry ingestion ----------------------------------------------

    @staticmethod
    def _row_body(value: str) -> dict | None:
        import json

        try:
            body = json.loads(value)
        except ValueError:
            return None
        return body if isinstance(body, dict) else None

    def _ingest(self, path: str, value: str) -> None:
        rid = path.partition("/")[2]
        body = self._row_body(value)
        if rid and body is not None:
            with self._lock:
                self.engine.ingest(rid, body)

    def _stub(self) -> RegistryStub:
        return RegistryStub(self._pool.get(
            self._endpoints.current(), self.tls, "component.registry"))

    def poll_once(self) -> None:
        """One GetValues sweep of the telemetry prefix (the mixed-
        version fallback, and the resync belt when the stream is not
        synced). Raises grpc.RpcError after rotating the endpoint."""
        address = self._endpoints.current()
        try:
            reply = self._stub().GetValues(
                pb.GetValuesRequest(path=REGISTRY_TELEMETRY), timeout=10.0)
        except grpc.RpcError as err:
            self._pool.maybe_evict(err, address)
            if self._endpoints.multiple and err.code() in FAILOVER_CODES \
                    and not self._endpoints.apply_hint(err):
                self._endpoints.advance()
            raise
        for value in reply.values:
            self._ingest(value.path, value.value)

    def _watch_once(self) -> None:
        from oim_tpu_torch.registry.watch import WatchConsumer

        address = self._endpoints.current()
        stub = self._stub()
        consumer = WatchConsumer()
        consumer.resume_token = self._resume_token

        def install(rows: dict) -> None:
            for path, value in rows.items():
                self._ingest(path, value)

        def put(path: str, value: str) -> None:
            self._ingest(path, value)

        def delete(path: str, expired: bool) -> None:
            # Expiry freezes (the replica's history still counts);
            # an explicit delete (deregistration) forgets the replica.
            if not expired:
                rid = path.partition("/")[2]
                if rid:
                    with self._lock:
                        self.engine.forget(rid)

        def on_sync() -> None:
            self._watch_synced = True

        def on_reset() -> None:
            self._watch_synced = False

        try:
            call = stub.Watch(pb.WatchRequest(
                path=REGISTRY_TELEMETRY, resume_token=self._resume_token))
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
                                consumer="slo_monitor",
                                reason="pre-watch registry: poll mode")
                    log.warning(
                        "registry has no Watch RPC; oim-monitor degrades "
                        "to GetValues polling")
                    return
                delay = backoff.next()
                log.debug("telemetry watch stream failed; backing off",
                          registry=self._endpoints.current(),
                          error=err.code().name, retry_s=round(delay, 2))
            if self._stop.wait(delay):
                return

    # -- evaluation + alert rows ------------------------------------------

    def tick_once(self, now: float | None = None) -> list[dict]:
        """One evaluation tick: poll when the stream is not carrying the
        view, evaluate, mirror transitions into alert rows, renew firing
        rows. Returns the engine's transitions."""
        if not self._watch_synced:
            try:
                self.poll_once()
            except grpc.RpcError:
                pass  # evaluate on the cached fleet view; backoff next tick
        with self._lock:
            transitions = self.engine.evaluate(now)
            firing = set(self.engine.firing())
        log = from_context()
        for transition in transitions:
            name = transition["slo"]
            if transition["transition"] == "fired":
                log.warning("SLO alert fired", slo=name,
                            burn_fast=round(transition["burn_fast"], 2),
                            burn_slow=round(transition["burn_slow"], 2))
            else:
                log.info("SLO alert resolved", slo=name)
        # Rows follow the firing SET (not just transitions): a row lost
        # to a registry outage at transition time is retried every tick.
        for name in firing:
            row = self._alert_rows.get(name)
            if row is None:
                row = self._alert_rows[name] = _AlertRow(
                    name, lambda n=name: self._status(n),
                    self.registry_address, self.interval, self.tls,
                    self._pool)
            try:
                row.beat_once()
            except grpc.RpcError as err:
                log.warning("alert row publish failed", alert=name,
                            error=err.code().name)
        for name in list(self._alert_rows):
            if name not in firing:
                self._alert_rows.pop(name).stop(deregister=True)
        return transitions

    def _status(self, name: str) -> dict:
        with self._lock:
            body = self.engine.status(name)
        body["monitor"] = self.monitor_id
        return body

    def fleet_quantiles(self, metric: str, qs=(0.5, 0.99)):
        with self._lock:
            return self.engine.fleet_quantiles(metric, qs)

    def _tick_loop(self) -> None:
        while not self._stop.wait(jittered(self.interval)):
            try:
                self.tick_once()
            except Exception as err:  # noqa: BLE001 - monitor must survive
                from_context().warning("SLO tick failed", error=repr(err))

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if self.watch_enabled:
            self._watch_thread = threading.Thread(
                target=self._watch_loop, name="oim-monitor-watch",
                daemon=True)
            self._watch_thread.start()
        self._tick_thread = threading.Thread(
            target=self._tick_loop, name="oim-monitor-tick", daemon=True)
        self._tick_thread.start()

    def stop(self, deregister: bool = True) -> None:
        self._stop.set()
        call = self._watch_call
        if call is not None:
            call.cancel()
        for attr in ("_watch_thread", "_tick_thread"):
            thread = getattr(self, attr)
            if thread is not None:
                thread.join(timeout=5.0)
                setattr(self, attr, None)
        for name in list(self._alert_rows):
            self._alert_rows.pop(name).stop(deregister=deregister)
