"""Watch streams: push invalidation for the registry's consumers.

OIM's premise that control traffic is "short-lived, infrequent"
(PAPER.md §0) broke once every router polled ``GetValues("serve")`` on
an interval and every ``oimctl --top`` re-read the telemetry namespace:
read load scales with consumers x poll rate, and a replica row change
is invisible until the next poll tick. The hub turns the registry's
committed mutations into a server-streaming delta feed (the etcd Watch
analog):

* **Deltas, not state.** Every committed KV mutation — the legacy
  write path, a quorum commit, a replication standby's apply — lands in
  a bounded in-memory ring and fans out to attached streams, scoped by
  the same prefix semantics as ``GetValues``.
* **Lease expiry is pushed.** A sweeper thread (running only while
  streams are attached, so pure-poll deployments keep the lazy
  read-time expiry accounting) walks the lease table and publishes an
  EXPIRED deletion the moment a row lapses — and a PUT when a swept-dead
  row is resurrected by a bare lease renewal (its value never changed,
  so no write would have re-announced it).
* **Resume tokens.** Every event carries ``<hub_id>:<seq>``. A client
  that reconnects with a token this hub still retains gets exactly the
  missed deltas; any other token (another node after a failover, aged
  out of the ring) degrades to a full snapshot — idempotent PUT replay,
  never silent loss.
* **Slow consumers are closed, not waited on.** Each stream owns a
  bounded queue; publishing never blocks the registry's write path. An
  overflowed stream is aborted RESOURCE_EXHAUSTED and the client
  resumes with its last token. Every shed lands a ``watch_stream_shed``
  flight-recorder event (prefix + queue high-water mark) and bumps
  ``oim_watch_shed_streams_total`` — at 1k-replica scale a silent shed
  is indistinguishable from a healthy idle stream.
* **Serialize once, fan out bytes.** A delta's resume token embeds only
  the hub-global sequence number, so the wire frame is identical for
  every stream: the hub serializes each committed delta ONCE at publish
  and live streams yield the shared bytes (the gRPC layer passes
  pre-serialized frames through). Only the per-stream synthetic events
  — RESET/SYNC markers and snapshot PUTs, whose tokens are
  stream-relative — are still built per stream. Publish cost is
  ``oim_watch_fanout_seconds``; before this the fan-out tax was
  streams x serialization.
* **Keepalives.** An idle stream yields a SYNC marker every
  ``keepalive`` seconds, so consumers (the router's replica table) can
  treat stream silence as registry trouble without a separate probe.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
import time

import grpc

from oim_tpu_torch.common import events, tracing
from oim_tpu_torch.common import metrics as M
from oim_tpu_torch.common.pathutil import path_has_prefix
from oim_tpu_torch.registry.db import get_registry_entries
from oim_tpu_torch.spec import oim_pb2 as pb

KIND_PUT = 1
KIND_DELETE = 2
KIND_EXPIRED = 3
KIND_SYNC = 4
KIND_RESET = 5

_KIND_LABEL = {KIND_PUT: "put", KIND_DELETE: "delete",
               KIND_EXPIRED: "expired", KIND_SYNC: "sync",
               KIND_RESET: "reset"}


class _Delta:
    """One committed mutation, as the ring and stream queues carry it."""

    __slots__ = ("seq", "kind", "path", "value", "lease", "wire")

    def __init__(self, seq: int, kind: int, path: str, value: str,
                 lease: float):
        self.seq = seq
        self.kind = kind
        self.path = path
        self.value = value
        self.lease = lease
        # The serialize-once wire frame: every stream's copy of this
        # delta is byte-identical (the resume token embeds only the
        # hub-global seq), so the hub serializes at first fan-out and
        # live streams yield these shared bytes.
        self.wire: bytes | None = None


class _Stream:
    """One attached watcher: its prefix scope and bounded queue."""

    __slots__ = ("parts", "queue", "dead", "high_water")

    def __init__(self, parts: list[str], maxsize: int):
        self.parts = parts
        self.queue: queue.Queue[_Delta] = queue.Queue(maxsize=maxsize)
        # Set when the queue overflowed (slow consumer): the serving
        # generator aborts the stream instead of the registry blocking.
        self.dead = threading.Event()
        # Deepest this stream's queue has been (post-put depth): the
        # shed event's diagnostic payload, and what oim_watch_queue_
        # depth_peak reports fleet-wide.
        self.high_water = 0


class WatchConsumer:
    """The client half of the Watch protocol: one state machine shared
    by every consumer (the router's replica table, ``oimctl --top
    --watch``, the chaos watcher) instead of three hand-rolled copies.

    Drives one server stream through callbacks, owning the two pieces
    that are easy to get wrong:

    * **RESET..SYNC rebuilds**: PUTs between a RESET and its SYNC are
      collected and handed to ``install`` as one atomic batch — never
      patched into the live view.
    * **Resume-token discipline**: a token is committed to
      ``self.resume_token`` only once the view it describes is
      INSTALLED — per event for live deltas and token replays, at the
      SYNC for a snapshot. A stream that dies mid-snapshot therefore
      resumes from the PRE-snapshot token and re-triggers the full
      RESET, instead of replaying deltas onto a view that was never
      built (a deleted row would survive as a routable ghost).
    """

    def __init__(self):
        self.resume_token = ""

    def run(self, call, *, install, put, delete,
            on_reset=None, on_sync=None, is_stopped=None) -> None:
        """Consume ``call`` until it ends. ``install(dict path->value)``
        replaces the view; ``put(path, value)`` / ``delete(path,
        expired)`` patch it; ``on_sync()`` fires on every SYNC (view
        complete / keepalive). Raises whatever the stream raises."""
        resetting = False
        pending: dict[str, str] = {}
        for event in call:
            if is_stopped is not None and is_stopped():
                call.cancel()
                return
            kind = event.kind
            if kind == KIND_RESET:
                resetting, pending = True, {}
                if on_reset is not None:
                    on_reset()
            elif kind == KIND_SYNC:
                if resetting:
                    install(pending)
                    resetting = False
                if event.resume_token:
                    self.resume_token = event.resume_token
                if on_sync is not None:
                    on_sync()
            elif kind == KIND_PUT:
                if resetting:
                    pending[event.value.path] = event.value.value
                else:
                    put(event.value.path, event.value.value)
                    if event.resume_token:
                        self.resume_token = event.resume_token
            elif kind in (KIND_DELETE, KIND_EXPIRED):
                if not resetting:
                    delete(event.value.path, kind == KIND_EXPIRED)
                    if event.resume_token:
                        self.resume_token = event.resume_token


class WatchHub:
    """Delta ring + stream fan-out + lease-expiry sweeper for one
    registry process (see module docstring)."""

    def __init__(
        self,
        service,
        retain: int = 4096,
        queue_max: int = 1024,
        sweep_interval: float = 0.25,
        keepalive: float = 2.0,
    ):
        self.service = service
        self.hub_id = os.urandom(6).hex()
        self.queue_max = queue_max
        self.sweep_interval = sweep_interval
        self.keepalive = keepalive
        self._ring: collections.deque[_Delta] = collections.deque(
            maxlen=retain)
        self._seq = 0
        self._streams: list[_Stream] = []
        # Paths the sweeper has declared dead (EXPIRED delivered): a
        # later PUT clears membership; a bare lease renewal that
        # resurrects one is announced as a PUT by the next sweep.
        self._dead: set[str] = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._sweeper: threading.Thread | None = None

    # -- publishing (called by every committed-mutation site) --------------

    def publish_kv(self, path: str, value: str, lease_seconds: float) -> None:
        """A committed SetValue-shaped mutation: PUT for a non-empty
        value, DELETE for the empty-value delete idiom."""
        kind = KIND_PUT if value != "" else KIND_DELETE
        self._publish(kind, path, value, lease_seconds)

    def publish_expired(self, path: str) -> None:
        self._publish(KIND_EXPIRED, path, "", 0.0)

    def _publish(self, kind: int, path: str, value: str,
                 lease: float) -> None:
        t0 = time.monotonic()
        with self._lock:
            self._seq += 1
            delta = _Delta(self._seq, kind, path, value, lease)
            self._ring.append(delta)
            if kind != KIND_EXPIRED:
                self._dead.discard(path)
            elif path not in self._dead:
                self._dead.add(path)
            streams = list(self._streams)
        fanned = False
        peak = 0
        for stream in streams:
            if stream.dead.is_set() or not path_has_prefix(path, stream.parts):
                continue
            if delta.wire is None:
                # Serialize ONCE for the whole fan-out: every stream's
                # frame for this delta is byte-identical.
                delta.wire = self._proto(delta).SerializeToString()
            fanned = True
            try:
                stream.queue.put_nowait(delta)
            except queue.Full:
                # Never block the write path on a watcher: close it
                # (loudly — the shed must be diagnosable at scale).
                self._shed(stream)
                continue
            depth = stream.queue.qsize()
            if depth > stream.high_water:
                stream.high_water = depth
            if depth > peak:
                peak = depth
        if fanned:
            M.WATCH_QUEUE_DEPTH.set(float(peak))
            M.WATCH_FANOUT_SECONDS.observe(
                time.monotonic() - t0, exemplar=tracing.trace_id())

    def _shed(self, stream: _Stream) -> None:
        stream.dead.set()
        M.WATCH_SHED_STREAMS.inc()
        events.emit(events.WATCH_STREAM_SHED,
                    prefix="/".join(stream.parts),
                    queue_high_water=stream.high_water,
                    queue_max=self.queue_max)

    # -- the expiry sweeper ------------------------------------------------

    def _ensure_sweeper(self) -> None:
        with self._lock:
            if self._sweeper is not None or self._stop.is_set():
                return
            self._sweeper = threading.Thread(
                target=self._sweep_loop, name="oim-watch-sweeper",
                daemon=True)
            self._sweeper.start()

    def _sweep_loop(self) -> None:
        leases = self.service.leases
        while not self._stop.wait(self.sweep_interval):
            with self._lock:
                if not self._streams:
                    continue  # idle: no watchers, keep expiry lazy
                dead = set(self._dead)
            for path in leases.sweep_expired():
                if path not in dead:
                    self.publish_expired(path)
            # Resurrections: a swept-dead row whose lease renewed (bare
            # Heartbeat — the value never changed, so no PUT fired).
            for path in dead:
                if leases.alive(path):
                    value = self.service.db.get(path)
                    if value:
                        remaining = leases.remaining(path)
                        self._publish(KIND_PUT, path, value,
                                      max(remaining or 0.0, 0.0))
                    else:
                        with self._lock:
                            self._dead.discard(path)

    # -- serving -----------------------------------------------------------

    def _token(self, seq: int) -> str:
        return f"{self.hub_id}:{seq}"

    def _parse_token(self, token: str) -> int | None:
        """The seq a valid-for-this-hub token names, else None."""
        hub, sep, seq = token.partition(":")
        if not sep or hub != self.hub_id:
            return None
        try:
            return int(seq)
        except ValueError:
            return None

    def _proto(self, delta: _Delta) -> pb.WatchEvent:
        event = pb.WatchEvent(kind=delta.kind,
                              resume_token=self._token(delta.seq))
        if delta.kind != KIND_SYNC:
            event.value.path = delta.path
            event.value.value = delta.value
            event.value.lease_seconds = delta.lease
        return event

    def _event(self, delta: _Delta) -> pb.WatchEvent:
        """A per-stream synthetic event (RESET/SYNC markers, snapshot
        PUTs): these carry stream-relative tokens, so they cannot share
        a wire frame."""
        M.WATCH_EVENTS.labels(kind=_KIND_LABEL[delta.kind]).inc()
        return self._proto(delta)

    def _wire(self, delta: _Delta) -> bytes:
        """The shared serialize-once frame for a ring delta (the gRPC
        response serializer passes bytes through untouched). Ring
        deltas published before any stream attached serialize here on
        first delivery."""
        M.WATCH_EVENTS.labels(kind=_KIND_LABEL[delta.kind]).inc()
        wire = delta.wire
        if wire is None:
            wire = delta.wire = self._proto(delta).SerializeToString()
        return wire

    def serve(self, request, context):
        """Generator behind ``Registry.Watch`` (authorization already
        checked by the service)."""
        parts = request.path.split("/") if request.path else []
        stream = _Stream(parts, self.queue_max)
        with self._lock:
            # Attach BEFORE reading state: a mutation racing the
            # snapshot lands in the queue and is deduped by seq below.
            self._streams.append(stream)
            attach_seq = self._seq
            ring = list(self._ring)
        M.WATCH_STREAMS.set(len(self._streams))
        self._ensure_sweeper()
        try:
            last_sent = attach_seq
            resume_seq = self._parse_token(request.resume_token)
            ring_floor = ring[0].seq - 1 if ring else attach_seq
            if resume_seq is not None and ring_floor <= resume_seq \
                    <= attach_seq:
                # Replay exactly the missed deltas, no snapshot.
                for delta in ring:
                    if delta.seq > resume_seq \
                            and path_has_prefix(delta.path, parts):
                        yield self._wire(delta)
            else:
                # Full snapshot of the live entries under the prefix.
                # RESET first: the consumer must forget its view and
                # rebuild from the PUTs that follow — without it, a row
                # deleted while the consumer was disconnected would
                # survive as a ghost.
                yield self._event(
                    _Delta(attach_seq, KIND_RESET, "", "", 0.0))
                entries = get_registry_entries(
                    self.service.db, request.path)
                leases = self.service.leases
                for path in sorted(entries):
                    if not leases.alive(path):
                        continue
                    remaining = leases.remaining(path)
                    yield self._event(_Delta(
                        attach_seq, KIND_PUT, path, entries[path],
                        max(remaining or 0.0, 0.0)))
            yield self._event(_Delta(last_sent, KIND_SYNC, "", "", 0.0))
            while context.is_active():
                if stream.dead.is_set():
                    context.abort(
                        grpc.StatusCode.RESOURCE_EXHAUSTED,
                        f"watch stream overflowed its {self.queue_max}-"
                        f"event queue (slow consumer); resume with the "
                        f"last token")
                try:
                    delta = stream.queue.get(timeout=self.keepalive)
                except queue.Empty:
                    yield self._event(
                        _Delta(last_sent, KIND_SYNC, "", "", 0.0))
                    continue
                if delta.seq <= last_sent:
                    continue  # duplicated by the replay/snapshot race
                last_sent = delta.seq
                yield self._wire(delta)
        finally:
            with self._lock:
                if stream in self._streams:
                    self._streams.remove(stream)
            M.WATCH_STREAMS.set(len(self._streams))

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            streams = list(self._streams)
            sweeper, self._sweeper = self._sweeper, None
        for stream in streams:
            stream.dead.set()
        if sweeper is not None:
            sweeper.join(timeout=5.0)
