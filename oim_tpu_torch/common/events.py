"""Flight recorder (``oim_tpu/common/events.py``): a bounded, thread-safe
ring of typed events, each stamped with the active trace_id.

Metrics answer "how often"; spans answer "how long"; the recorder answers
"WHAT happened to this request": the incidents (a slot evicted, the page
pool exhausted, speculation falling back, a drain, a stage-cache
eviction) that a request's trace_id touched. Every emit site records a
typed event with the ambient ``tracing.trace_id()``, the ring keeps the
recent past bounded, and two exits serve it: ``GET /debug/events`` on the
metrics server (filterable by ``?trace=`` / ``?type=``), and a
``<service>-<pid>.events.json`` dump into ``--trace-dir`` on SIGQUIT, an
unhandled crash or a clean shutdown (``cli/common.py``).

Event attribute values pass through ``redact_text`` at EMIT time, so no
exit can leak a credential. ``oim_events_total{type}`` counts emissions,
so rates survive the ring's wrap.

The port declares the event types its own modules emit.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Any

from oim_tpu_torch.common import metrics as M
from oim_tpu_torch.common.redact import redact_text

# Canonical event types (the emit sites: serve/engine.py,
# serve/kvvolume.py, controller/stagecache.py, feeder/driver.py,
# registry/ and router/).
LEASE_EXPIRED = "lease_expired"
FEEDER_FAILOVER = "feeder_failover"
VOLUME_HEALED = "volume_healed"
REGISTRY_PROMOTION = "registry_promotion"
REGISTRY_DEMOTION = "registry_demotion"
# Quorum mode (registry/quorum.py): a follower opened an election
# (term++ campaign); a leader that lost majority contact stepped down
# WITHOUT a successor having claimed a higher term yet. The winner of
# an election emits REGISTRY_PROMOTION (the pair-mode event), a member
# adopting a higher term emits REGISTRY_DEMOTION.
REGISTRY_ELECTION = "registry_election"
REGISTRY_STEPDOWN = "registry_stepdown"
# A watch consumer lost its stream/token and fell back to a full
# snapshot resync (or to GetValues polling against a registry without
# the Watch RPC).
WATCH_RESYNC = "watch_resync"
# The hub closed a Watch stream because the consumer overflowed its
# bounded queue (registry/watch.py slow-consumer shed).
WATCH_STREAM_SHED = "watch_stream_shed"
ROUTER_RETRY = "router_retry"
ROUTER_MARK_FAILED = "router_mark_failed"
# The replica table aged past --max-stale: the router is REFUSING picks.
# The recovery twin fires on the first successful refresh after that.
ROUTER_TABLE_STALE = "router_table_stale"
ROUTER_TABLE_RECOVERED = "router_table_recovered"
REPLICA_DRAIN = "replica_drain"
STAGE_CACHE_EVICTION = "stage_cache_eviction"
SLOT_EVICTED = "slot_evicted"
PAGE_POOL_EXHAUSTED = "page_pool_exhausted"
SPEC_FALLBACK = "spec_fallback"
# KV tiering / fleet prefix sharing (serve/kvvolume.py): a hot chain
# exported as a content-addressed volume; an admission adopted
# peer-fetched KV blocks; a peer fetch that STARTED but failed (holder
# died mid-stream, bad blob) fell back to local recompute.
KV_CHAIN_EXPORTED = "kv_chain_exported"
KV_PEER_FETCH = "kv_peer_fetch"
KV_FETCH_FALLBACK = "kv_fetch_fallback"
# Fleet SLO plane (obs/slo.py): a declared SLO's multi-window burn rate
# crossed the alert threshold / stayed back under it for the resolve
# hold. One fired per episode, so fired and resolved arrive in pairs.
SLO_ALERT_FIRED = "slo_alert_fired"
SLO_ALERT_RESOLVED = "slo_alert_resolved"
# Fleet actuator (autoscale/daemon.py): a spawn toward a higher target,
# a drain toward a lower one (reason="upgrade" for the stale half of an
# upgrade flip), one replica's version rollover, and an autoscaler
# claiming the fleet/ leadership row.
AUTOSCALE_SCALE_UP = "autoscale_scale_up"
AUTOSCALE_SCALE_DOWN = "autoscale_scale_down"
AUTOSCALE_UPGRADE_FLIP = "autoscale_upgrade_flip"
AUTOSCALE_TAKEOVER = "autoscale_takeover"
SHARD_MEMBER_LOST = "shard_member_lost"
SHARD_MEMBER_HEALED = "shard_member_healed"

DEFAULT_CAPACITY = 2048


class Event:
    """One recorded incident; immutable once emitted."""

    __slots__ = ("seq", "type", "ts_unix", "trace_id", "attrs")

    def __init__(self, seq: int, type_: str, ts_unix: float,
                 trace_id: str, attrs: dict[str, Any]):
        self.seq = seq
        self.type = type_
        self.ts_unix = ts_unix
        self.trace_id = trace_id
        self.attrs = attrs

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "seq": self.seq,
            "type": self.type,
            "ts": self.ts_unix,
        }
        if self.trace_id:
            d["trace_id"] = self.trace_id
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class EventRecorder:
    """Bounded ring (deque) of Events. ``capacity=0`` disables recording
    entirely — the observability-overhead bench's "off" configuration."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(0, capacity)
        self._events: collections.deque[Event] = collections.deque(
            maxlen=self.capacity or 1)
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self._emitted = 0

    # -- recording --------------------------------------------------------

    def emit(self, type_: str, trace_id: str | None = None,
             **attrs: Any) -> Event | None:
        """Record one event. ``trace_id`` defaults to the ambient span's
        (tracing.trace_id()); string attribute values are redacted. The
        emit path is a deque append under one lock — cheap enough to
        leave on in production (``chip_smoke.py`` times it)."""
        if self.capacity == 0:
            return None
        if trace_id is None:
            from oim_tpu_torch.common import tracing

            trace_id = tracing.trace_id()
        clean = {
            k: redact_text(v) if isinstance(v, str) else v
            for k, v in attrs.items()
        }
        event = Event(next(self._seq), type_, time.time(), trace_id, clean)
        with self._lock:
            self._events.append(event)
            self._emitted += 1
        M.EVENTS_TOTAL.labels(type=type_).inc()
        return event

    # -- reading ----------------------------------------------------------

    def events(self, trace_id: str = "", type_: str = "",
               limit: int = 0) -> list[Event]:
        """Ring snapshot, oldest first, optionally filtered; ``limit``
        keeps the NEWEST n after filtering."""
        with self._lock:
            snapshot = list(self._events)
        if trace_id:
            snapshot = [e for e in snapshot if e.trace_id == trace_id]
        if type_:
            snapshot = [e for e in snapshot if e.type == type_]
        if limit > 0:
            snapshot = snapshot[-limit:]
        return snapshot

    def counts(self) -> dict[str, int]:
        """Events per type currently in the ring (the `oimctl --top`
        "recent events" column; lifetime rates live in
        oim_events_total)."""
        with self._lock:
            snapshot = list(self._events)
        out: dict[str, int] = {}
        for e in snapshot:
            out[e.type] = out.get(e.type, 0) + 1
        return out

    @property
    def emitted(self) -> int:
        with self._lock:
            return self._emitted

    def to_json(self, trace_id: str = "", type_: str = "",
                limit: int = 0) -> str:
        events = self.events(trace_id, type_, limit)
        with self._lock:
            dropped = max(self._emitted - len(self._events), 0)
        return json.dumps({
            "events": [e.to_dict() for e in events],
            "dropped": dropped,
        })

    # -- export -----------------------------------------------------------

    def dump(self, path: str) -> None:
        """Write the ring as one complete JSON document (the post-mortem
        artifact next to the span trace files)."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.to_json())
        os.replace(tmp, path)


_recorder = EventRecorder()


def configure(capacity: int = DEFAULT_CAPACITY) -> EventRecorder:
    """Install the process-global recorder (one per daemon). Returns it."""
    global _recorder
    _recorder = EventRecorder(capacity)
    return _recorder


def recorder() -> EventRecorder:
    return _recorder


def emit(type_: str, trace_id: str | None = None,
         **attrs: Any) -> Event | None:
    """Record one event on the process-global recorder (the emit-site
    API: ``events.emit(events.ROUTER_RETRY, replica=rid, code=...)``)."""
    return _recorder.emit(type_, trace_id=trace_id, **attrs)


def dump_to(trace_dir: str, service: str) -> str:
    """Dump the global ring to ``<trace_dir>/<service>-<pid>.events.json``
    (SIGQUIT / crash / shutdown path). Returns the path."""
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{service}-{os.getpid()}.events.json")
    _recorder.dump(path)
    return path
