"""Registry replication: journal-streaming primary/standby pair.

The reference aspires to an etcd-backed registry and never builds one
(``registry/db.py`` docstring, SURVEY §0); after the PR 1 health plane the
registry itself became the control plane's single point of failure — lease
state and the ``<id>/address`` map die with its host. This module is the
minimal honest replicated backend: one PRIMARY serves writes and streams
its *logical journal* to one STANDBY over the ``Replicate`` RPC; the
standby applies the records into its own DB + ``LeaseTable`` and serves
reads, refusing writes with ``FAILED_PRECONDITION: standby`` until
promoted.

Design points, in the order they matter:

* **Logical records, not raw state.** Lease deadlines are monotonic-clock
  values and cannot be shipped; instead lease *grants* travel with their
  TTL inside KV records and lease *renewals* (heartbeats the primary
  served) travel as explicit RENEW records, each re-based on the
  receiver's own clock. Expiry is never replicated — it is derived
  independently on each node, so a partitioned standby still expires dead
  controllers on time.
* **Snapshot + tail.** The in-memory journal retains a bounded window; a
  follower whose offset fell out of the window (or whose ``log_id`` does
  not match — offsets are only comparable within one primary incarnation)
  is restarted from a full snapshot bracketed by SNAPSHOT_BEGIN/END, then
  tails live records. Snapshot KV records carry *remaining* TTLs so a
  nearly-dead lease is not resurrected at full strength.
* **The primary's own lease.** The stream carries periodic HEARTBEAT
  records; the standby treats them as the primary's lease and, when they
  stop for longer than the advertised TTL, auto-promotes — bumping its
  promotion epoch and re-running the PR 1 boot-grace path for controller
  keys that have *no* lease (keys whose replicated lease already expired
  stay expired: a controller killed before the failover must not be
  resurrected).
* **Split-brain avoidance.** The standby refuses writes until promoted.
  Epochs totally order promotions: a registry that sees a HIGHER epoch
  than its own — in a ``Replicate`` request, a probe reply, or a stream
  HELLO — demotes itself to standby and resyncs. A primary with a
  configured peer probes it periodically, so a resurrected old primary
  discovers the new one within one probe interval even if no client
  tells it. Equal-epoch dual primaries (operator error) tie-break on
  ``log_id`` so exactly one side demotes.
"""

from __future__ import annotations

import http.server
import json
import os
import threading
import time

import grpc

from oim_tpu_torch.common import faultinject, metrics as M
from oim_tpu_torch.common.backoff import jittered
from oim_tpu_torch.common.endpoints import RegistryEndpoints
from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.common.pathutil import REGISTRY_ADDRESS, REGISTRY_MESH
from oim_tpu_torch.common.channelpool import ChannelPool
from oim_tpu_torch.registry.db import get_registry_entries
from oim_tpu_torch.spec import oim_pb2 as pb
from oim_tpu_torch.spec.services import RegistryStub

PRIMARY = "PRIMARY"
STANDBY = "STANDBY"

# Reserved registry id: "registry/..." keys are the replication status /
# control namespace when a ReplicationManager is attached (virtual,
# admin-only, never replicated or leased).
RESERVED_REGISTRY_ID = "registry"
PROMOTE_KEY = f"{RESERVED_REGISTRY_ID}/promote"

# ReplicateRecord.kind values (spec.md).
KIND_HELLO = 1
KIND_SNAPSHOT_BEGIN = 2
KIND_KV = 3
KIND_SNAPSHOT_END = 4
KIND_RENEW = 5
KIND_HEARTBEAT = 6

# TTL shipped for a snapshot entry whose lease has ALREADY expired: near
# zero so the follower sees it stale immediately, but non-zero so it does
# not become permanent (grant(0) removes the lease).
_EXPIRED_SNAPSHOT_TTL = 1e-3


class ReplicationLog:
    """Bounded in-memory journal of replication records.

    Offsets are absolute and monotonically increasing for the lifetime of
    one primary process; ``log_id`` names that lifetime so a follower
    never resumes mid-offset against a restarted (renumbered) journal.
    Only a window of ``retain`` records is kept — heartbeat renewals from
    a large fleet would otherwise grow the log without bound — and a
    follower that falls out of the window is resynced by snapshot.
    """

    def __init__(self, retain: int = 4096):
        self.log_id = os.urandom(8).hex()
        self._retain = retain
        self._records: list[pb.ReplicateRecord] = []
        self._start = 0
        self._next = 0
        self._cond = threading.Condition()

    @property
    def next_offset(self) -> int:
        with self._cond:
            return self._next

    @property
    def start_offset(self) -> int:
        with self._cond:
            return self._start

    def append_kv(self, path: str, value: str, lease_seconds: float) -> None:
        self._append(pb.ReplicateRecord(
            kind=KIND_KV,
            value=pb.Value(path=path, value=value,
                           lease_seconds=lease_seconds),
        ))

    def append_renew(self, prefix: str, ttl: float) -> None:
        self._append(pb.ReplicateRecord(
            kind=KIND_RENEW, renew_prefix=prefix, renew_ttl=ttl))

    def _append(self, rec: pb.ReplicateRecord) -> None:
        with self._cond:
            rec.offset = self._next
            self._next += 1
            self._records.append(rec)
            if len(self._records) > self._retain:
                drop = len(self._records) - self._retain
                del self._records[:drop]
                self._start += drop
            self._cond.notify_all()

    def collect(
        self, from_offset: int, timeout: float
    ) -> tuple[list[pb.ReplicateRecord], bool]:
        """Records from ``from_offset`` on, blocking up to ``timeout`` for
        new ones. Returns ``(records, needs_snapshot)``: a follower ahead
        of the log (restarted primary) or behind its retained window must
        be resynced by snapshot."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                if from_offset > self._next or from_offset < self._start:
                    return [], True
                if from_offset < self._next:
                    return list(self._records[from_offset - self._start:]), False
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return [], False
                self._cond.wait(remaining)


class _StaleEpoch(Exception):
    """The stream's sender has a LOWER epoch than we do (a stale primary);
    stop applying its records."""


class ReplicationManager:
    """Role, epoch, journal, and the standby follower threads of one
    registry process. Attaches itself to the ``RegistryService`` it is
    constructed with (``service.replication = self``).

    This is the 2-node legacy mode: one primary, one standby, failover
    by watchdog lease (auto) or ``oimctl --promote`` (manual). The
    3+ member raft-style mode lives in registry/quorum.py and shares
    this module's journal/snapshot machinery."""

    # Distinguishes the write path: the legacy pair applies-then-
    # journals; quorum mode proposes-and-waits (registry.py SetValue).
    quorum = False

    BACKOFF_BASE = 0.2
    BACKOFF_MAX = 5.0

    def __init__(
        self,
        service,
        peer: str | list[str],
        role: str = PRIMARY,
        primary_lease_seconds: float = 10.0,
        boot_grace_seconds: float = 150.0,
        state_file: str = "",
    ):
        role = role.upper()
        if role not in (PRIMARY, STANDBY):
            raise ValueError(f"role must be PRIMARY or STANDBY, not {role!r}")
        self.service = service
        self.db = service.db
        self.leases = service.leases
        self.tls = service.tls
        self.peer = RegistryEndpoints(peer)
        self.role = role
        self.epoch = 0
        self.primary_lease_seconds = primary_lease_seconds
        self.boot_grace_seconds = boot_grace_seconds
        self.state_file = state_file
        self.log = ReplicationLog()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # Wakes the tail loop out of its probe/backoff sleep on role
        # transitions: a freshly-demoted node must attempt its first
        # follow BEFORE the watchdog lease elapses, or it would re-promote
        # against a live primary and the pair would flap.
        self._wake = threading.Event()
        self._threads: list[threading.Thread] = []
        self._call = None  # in-flight follower stream, cancellable
        # Own pool (not the process-shared one): stop() closes it, and a
        # test process running several registries must not cross their
        # channel lifetimes.
        self._pool = ChannelPool()
        # Follower state. (_applied, _peer_log_id) always describe a
        # CONSISTENT position: they only move together at SNAPSHOT_END or
        # record-by-record while tailing — never at HELLO, so a stream
        # lost mid-snapshot resumes with the OLD position and forces the
        # snapshot to restart instead of tailing past the missing half.
        self._applied = 0
        self._peer_log_id = ""
        self._stream_log_id = ""  # the in-flight stream's journal id
        self._peer_epoch = 0
        self._peer_next = 0
        self._advertised_lease = 0.0
        self._last_activity = time.monotonic()
        self._in_snapshot = False
        self._snapshot_seen: set[str] = set()
        # True once a snapshot has completed this process lifetime: the
        # auto-promotion guard (see _may_auto_promote).
        self._synced = False
        # Whether the DB held state BEFORE any replication ran (journal
        # replay): captured now because current contents can't be trusted
        # later — a partially applied snapshot also populates the DB.
        self._boot_state = bool(get_registry_entries(self.db, ""))
        self._load_state()
        M.REGISTRY_ROLE.set(1.0 if self.role == PRIMARY else 0.0)
        service.replication = self

    # -- persistence -------------------------------------------------------

    def _load_state(self) -> None:
        if not self.state_file or not os.path.exists(self.state_file):
            return
        try:
            with open(self.state_file, encoding="utf-8") as f:
                self.epoch = int(json.load(f).get("epoch", 0))
        except (ValueError, OSError):
            pass  # corrupt sidecar: epoch 0, the peer probe re-syncs it

    def _save_state(self) -> None:
        if not self.state_file:
            return
        tmp = f"{self.state_file}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"epoch": self.epoch, "role": self.role}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.state_file)

    # -- primary-side journal feed (called by RegistryService) -------------

    @property
    def is_primary(self) -> bool:
        return self.role == PRIMARY

    def leader_hint(self) -> str:
        """Where writes should go instead, when known. The pair mode has
        no authoritative view of the peer's role — clients rotate their
        endpoint list on FAILED_PRECONDITION — so no hint is offered."""
        return ""

    def record_kv(self, path: str, value: str, lease_seconds: float) -> None:
        if self.role == PRIMARY:
            self.log.append_kv(path, value, lease_seconds)

    def record_renew(self, prefix: str, ttl: float) -> None:
        if self.role == PRIMARY:
            self.log.append_renew(prefix, ttl)

    # -- role transitions --------------------------------------------------

    def promote(self, reason: str = "") -> bool:
        """Standby -> primary. Returns False when already primary (the
        admin ``--promote`` path is idempotent)."""
        with self._lock:
            if self.role == PRIMARY:
                return False
            self.epoch = max(self.epoch, self._peer_epoch) + 1
            self.role = PRIMARY
            self._save_state()
            epoch = self.epoch
        call, self._call = self._call, None
        if call is not None:
            call.cancel()
        self._wake.set()  # switch the tail loop into probe mode promptly
        # The PR 1 boot-grace path, applied at promotion — but ONLY when
        # this node never synced this lifetime (promoted straight off a
        # journal replay, where lease state was genuinely lost): then
        # lease-less controller-layout keys get a grace lease so live
        # controllers renew within one heartbeat and dead ones expire. A
        # SYNCED standby's lease table is authoritative — replicated
        # permanent keys (admin pins: "operator pins survive any
        # heartbeat failure") stay permanent, replicated-expired keys
        # stay dead.
        with self._lock:
            synced = self._synced
        if self.boot_grace_seconds > 0 and not synced:
            for path in get_registry_entries(self.db, ""):
                parts = path.split("/")
                if (len(parts) == 2
                        and parts[1] in (REGISTRY_ADDRESS, REGISTRY_MESH)
                        and self.leases.remaining(path) is None):
                    self.leases.grant(path, self.boot_grace_seconds)
        M.REGISTRY_PROMOTIONS.inc()
        M.REGISTRY_ROLE.set(1.0)
        from oim_tpu_torch.common import events

        events.emit(events.REGISTRY_PROMOTION, epoch=epoch,
                    reason=reason or "admin")
        # The outage-sized lag that triggered the promotion must not keep
        # exporting from the new primary (it would alert forever).
        M.REPL_LAG_RECORDS.set(0.0)
        M.REPL_LAG_SECONDS.set(0.0)
        from_context().warning(
            "promoted to PRIMARY", epoch=epoch, reason=reason or "admin")
        return True

    def demote(self, peer_epoch: int, reason: str = "") -> None:
        """Primary (or stale standby) adopts the peer's higher epoch and
        follows it. Forces a snapshot resync: this node's journal/state
        may contain writes the new primary never saw."""
        with self._lock:
            self.epoch = max(self.epoch, peer_epoch)
            self._peer_epoch = max(self._peer_epoch, peer_epoch)
            was_primary = self.role == PRIMARY
            self.role = STANDBY
            self._save_state()
            self._applied = 0
            self._peer_log_id = ""
            self._advertised_lease = 0.0  # re-learned from the new primary
            self._last_activity = time.monotonic()
        # Sever any in-flight follow of the SUPERSEDED primary: its
        # KV/RENEW records carry no epoch, so without the cancel they
        # would keep applying split-brain writes until its next heartbeat.
        call, self._call = self._call, None
        if call is not None:
            call.cancel()
        self._wake.set()  # follow the new primary NOW, not a sleep later
        if was_primary:
            M.REGISTRY_ROLE.set(0.0)
            from oim_tpu_torch.common import events

            events.emit(events.REGISTRY_DEMOTION, epoch=self.epoch,
                        reason=reason or f"peer epoch {peer_epoch}")
            from_context().warning(
                "demoted to STANDBY", epoch=self.epoch,
                reason=reason or f"peer epoch {peer_epoch}")

    # -- status ------------------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            lag_records = max(0, self._peer_next - self._applied)
            lag_seconds = time.monotonic() - self._last_activity
            st = {
                "role": self.role,
                "epoch": self.epoch,
                "peer": ",".join(self.peer.all()),
                "applied_offset": self._applied,
                "next_offset": self.log.next_offset,
                "lag_records": lag_records if self.role == STANDBY else 0,
                "lag_seconds": round(lag_seconds, 3)
                if self.role == STANDBY else 0.0,
            }
        journal_bytes = getattr(self.db, "journal_bytes", None)
        st["journal_bytes"] = journal_bytes() if journal_bytes else 0
        return st

    def status_entries(self) -> dict[str, str]:
        """The virtual ``registry/...`` KV view of :meth:`status`, merged
        into ``GetValues`` replies (never stored, leased, or replicated)."""
        st = self.status()
        return {
            f"{RESERVED_REGISTRY_ID}/role": st["role"],
            f"{RESERVED_REGISTRY_ID}/epoch": str(st["epoch"]),
            f"{RESERVED_REGISTRY_ID}/peer": st["peer"],
            f"{RESERVED_REGISTRY_ID}/replication/lag_records":
                str(st["lag_records"]),
            f"{RESERVED_REGISTRY_ID}/replication/lag_seconds":
                f"{st['lag_seconds']:.3f}",
            f"{RESERVED_REGISTRY_ID}/replication/next_offset":
                str(st["next_offset"]),
            f"{RESERVED_REGISTRY_ID}/replication/journal_bytes":
                str(st["journal_bytes"]),
        }

    # -- server side: the Replicate stream ---------------------------------

    def serve(self, request, context):
        """Generator behind ``Registry.Replicate`` (authorization already
        checked by the service)."""
        with self._lock:
            my_epoch = self.epoch
        if request.epoch > my_epoch:
            # The caller promoted past us: we are the old primary (or a
            # stale standby). Demote BEFORE aborting so the very next
            # client write is already refused.
            self.demote(request.epoch, reason="superseded by Replicate peer")
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                f"superseded: peer epoch {request.epoch} > local {my_epoch}",
            )
        yield pb.ReplicateRecord(
            kind=KIND_HELLO,
            offset=self.log.next_offset,
            epoch=my_epoch,
            primary_lease_seconds=self.primary_lease_seconds,
            log_id=self.log.log_id,
            role=self.role,
        )
        if request.probe:
            return
        if self.role != PRIMARY:
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "standby does not serve the journal; replicate from the "
                "primary",
            )
        cursor = (
            request.from_offset
            if request.log_id == self.log.log_id else None
        )
        beat = (
            max(self.primary_lease_seconds / 3.0, 0.05)
            if self.primary_lease_seconds > 0 else 1.0
        )
        last_beat = time.monotonic()
        while context.is_active() and self.role == PRIMARY:
            if cursor is None:
                cursor = yield from self._snapshot_records()
                continue
            records, needs_snapshot = self.log.collect(cursor, timeout=beat)
            if needs_snapshot:
                cursor = None
                continue
            for rec in records:
                yield rec
                cursor = rec.offset + 1
            now = time.monotonic()
            if now - last_beat >= beat:
                yield pb.ReplicateRecord(
                    kind=KIND_HEARTBEAT,
                    offset=self.log.next_offset,
                    epoch=self.epoch,
                )
                last_beat = now

    def _snapshot_records(self):
        """Stream a full-state snapshot; returns the offset tailing resumes
        from. The resume offset is captured BEFORE reading state, so a
        mutation racing the snapshot appears in the tail too — applying it
        twice is idempotent (same set, same grant)."""
        resume = self.log.next_offset
        yield pb.ReplicateRecord(kind=KIND_SNAPSHOT_BEGIN)
        entries = get_registry_entries(self.db, "")
        for path in sorted(entries):
            remaining = self.leases.remaining(path)
            if remaining is None:
                ttl = 0.0  # permanent entry
            elif remaining > 0:
                ttl = remaining
            else:
                ttl = _EXPIRED_SNAPSHOT_TTL
            yield pb.ReplicateRecord(
                kind=KIND_KV,
                value=pb.Value(
                    path=path, value=entries[path], lease_seconds=ttl),
            )
        yield pb.ReplicateRecord(kind=KIND_SNAPSHOT_END, offset=resume)
        return resume

    # -- standby side: follow + apply --------------------------------------

    def start(self, initial_probe: bool = True) -> None:
        """Probe the peer once (role/epoch discovery: a rejoining old
        primary demotes itself here, before serving a single write), then
        start the follower + watchdog threads."""
        if initial_probe:
            self._probe_peer(timeout=2.0)
        for target in (self._tail_loop, self._watchdog_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        call = self._call
        if call is not None:
            call.cancel()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()
        self._pool.close()

    def _pause(self, timeout: float) -> bool:
        """Sleep until ``timeout``, a role transition, or shutdown.
        Returns True when stopping."""
        self._wake.wait(timeout)
        self._wake.clear()
        return self._stop.is_set()

    def _peer_channel(self, target: str) -> grpc.Channel:
        # Pooled: the follow loop reconnects every stream loss and every
        # backoff tick — per-reconnect dialing paid a TLS handshake each
        # time. Transport failures evict (``maybe_evict``), so a restarted
        # or re-pointed peer still gets a fresh dial.
        return self._pool.get(target, self.tls, "component.registry")

    def _probe_peer(self, timeout: float = 5.0):
        """One HELLO round trip. Demotes a primary that discovers a
        higher-epoch peer (or loses the equal-epoch ``log_id`` tie-break
        against another primary — operator-error dual primaries converge
        to exactly one)."""
        target = self.peer.current()
        try:
            call = RegistryStub(self._peer_channel(target)).Replicate(
                pb.ReplicateRequest(
                    epoch=self.epoch, log_id=self.log.log_id, probe=True),
                timeout=timeout,
            )
            hello = next(iter(call), None)
        except grpc.RpcError as err:
            self._pool.maybe_evict(err, target)
            self.peer.advance()
            return None
        if hello is None or hello.kind != KIND_HELLO:
            return None
        with self._lock:
            self._peer_epoch = max(self._peer_epoch, hello.epoch)
        if self.role == PRIMARY and (
            hello.epoch > self.epoch
            or (hello.epoch == self.epoch and hello.role == PRIMARY
                and self.log.log_id < hello.log_id)
        ):
            self.demote(hello.epoch, reason="peer probe found newer primary")
        return hello

    def _tail_loop(self) -> None:
        """As STANDBY: follow the primary's journal. As PRIMARY: probe the
        peer periodically (the live half of split-brain healing)."""
        log = from_context()
        delay = self.BACKOFF_BASE
        while not self._stop.is_set():
            if self.role == PRIMARY:
                self._probe_peer()
                interval = max(self.primary_lease_seconds, 1.0)
                if self._pause(interval):
                    return
                continue
            try:
                self._follow_once()
                delay = self.BACKOFF_BASE  # clean stream end: retry soon
            except _StaleEpoch:
                log.warning(
                    "stale-epoch primary on replication stream; waiting",
                    peer=self.peer.current(), epoch=self.epoch)
            except faultinject.InjectedFault:
                pass  # armed replication.apply: sever the stream, retry
            except grpc.RpcError as err:
                log.debug(
                    "replication stream failed; backing off",
                    peer=self.peer.current(),
                    error=err.details() or str(err.code()),
                    retry_s=round(delay, 2))
                self.peer.advance()
            # The reconnect cadence must outpace the auto-promotion lease:
            # a follower still backing off when the watchdog fires would
            # promote against a LIVE primary (and the pair would flap).
            lease = self._effective_primary_lease()
            cap = min(self.BACKOFF_MAX, lease / 2) if lease > 0 \
                else self.BACKOFF_MAX
            # The cap is dynamic (lease/2, re-read each pass), so this
            # loop keeps its own doubling — but the jitter draw rides
            # common/backoff.py's shared source, so a seeded use_rng()
            # (the chaos ladder) controls this clock too.
            if self._pause(jittered(min(delay, cap))):
                return
            delay = min(delay * 2, cap)

    def _follow_once(self) -> None:
        target = self.peer.current()
        channel = self._peer_channel(target)
        try:
            with self._lock:
                request = pb.ReplicateRequest(
                    from_offset=self._applied,
                    epoch=self.epoch,
                    log_id=self._peer_log_id,
                )
            call = RegistryStub(channel).Replicate(request)
            self._call = call
            for rec in call:
                if self._stop.is_set() or self.role != STANDBY:
                    call.cancel()
                    return
                self._apply(rec)
        except grpc.RpcError as err:
            # A dead stream is the one place the pool can't self-heal:
            # evict before the tail loop's backoff so the reconnect dials
            # fresh instead of riding the broken socket.
            self._pool.maybe_evict(err, target)
            raise
        finally:
            self._call = None
            # A stream that died mid-snapshot must not leave apply state
            # behind: the next stream restarts its own snapshot.
            self._in_snapshot = False
            self._snapshot_seen = set()

    def _apply(self, rec) -> None:
        faultinject.fire("replication.apply", kind=rec.kind)
        if rec.kind == KIND_HELLO:
            with self._lock:
                if rec.epoch < self.epoch:
                    raise _StaleEpoch(rec.epoch)
                self._peer_epoch = max(self._peer_epoch, rec.epoch)
                self._peer_next = rec.offset
                if rec.primary_lease_seconds > 0:
                    self._advertised_lease = rec.primary_lease_seconds
                # Not committed to (_peer_log_id, _applied) yet: a new
                # primary incarnation renumbers us ONLY once its snapshot
                # completes (SNAPSHOT_END). Until then every reconnect
                # re-sends the old position and re-triggers the snapshot.
                self._stream_log_id = rec.log_id
            if rec.role != PRIMARY:
                # A HELLO from a fellow STANDBY is not primary liveness:
                # counting it would keep a both-standby pair (operator
                # error / rejoin races) refreshing each other's watchdog
                # forever, with neither ever auto-promoting.
                return
        elif rec.kind == KIND_SNAPSHOT_BEGIN:
            self._in_snapshot = True
            self._snapshot_seen = set()
        elif rec.kind == KIND_KV:
            value = rec.value
            # Through the service's committed-mutation funnel, so a
            # standby's Watch streams see the delta too (watch-across-
            # failover: a watcher re-targeting the promoted standby
            # resumes against the same state its primary stream left).
            self.service.apply_kv(
                value.path, value.value, value.lease_seconds)
            if value.value != "" and self._in_snapshot:
                self._snapshot_seen.add(value.path)
            if not self._in_snapshot:
                with self._lock:
                    self._applied = rec.offset + 1
            M.REPL_RECORDS_APPLIED.inc()
        elif rec.kind == KIND_SNAPSHOT_END:
            # Keys we hold that the snapshot did not mention were deleted
            # on the primary while we were disconnected.
            for path in set(get_registry_entries(self.db, "")) \
                    - self._snapshot_seen:
                self.service.apply_kv(path, "", 0.0)
            self._in_snapshot = False
            self._snapshot_seen = set()
            with self._lock:
                self._applied = rec.offset
                self._peer_log_id = self._stream_log_id
                self._synced = True
            compact = getattr(self.db, "compact", None)
            if compact is not None:
                # The snapshot re-wrote every key through the journal;
                # collapse it back to one record per live key.
                compact()
            M.REPL_RECORDS_APPLIED.inc()
        elif rec.kind == KIND_RENEW:
            self.service.apply_renew(rec.renew_prefix, rec.renew_ttl)
            with self._lock:
                self._applied = rec.offset + 1
            M.REPL_RECORDS_APPLIED.inc()
        elif rec.kind == KIND_HEARTBEAT:
            with self._lock:
                if rec.epoch < self.epoch:
                    raise _StaleEpoch(rec.epoch)
                self._peer_next = rec.offset
        with self._lock:
            self._last_activity = time.monotonic()
            if self.role == STANDBY:
                M.REPL_LAG_RECORDS.set(
                    max(0, self._peer_next - self._applied))
                M.REPL_LAG_SECONDS.set(0.0)

    def _effective_primary_lease(self) -> float:
        """The TTL the watchdog holds the primary to: the primary's
        advertised value when one was heard (its heartbeat cadence derives
        from ITS flag, so holding it to our own shorter flag would
        false-promote). Our own flag at 0 is an operator override —
        auto-promotion disabled on this node no matter what the peer
        advertises (the manual-promote-under-partition stance)."""
        with self._lock:
            if self.primary_lease_seconds <= 0:
                return 0.0
            return self._advertised_lease or self.primary_lease_seconds

    def _may_auto_promote(self) -> bool:
        """A standby without COMPLETE state must not auto-promote: a fresh
        pod racing a briefly-unreachable primary — or one whose only
        "state" is a partially applied snapshot — would otherwise promote,
        supersede the healthy primary by epoch, and the demotion resync
        would wipe the keys it never received. Complete means a snapshot
        finished this lifetime (_synced) or the DB replayed a journal from
        a previous one (_boot_state, captured before replication could
        half-populate the DB)."""
        with self._lock:
            return self._synced or self._boot_state

    def _watchdog_loop(self) -> None:
        """Auto-promotion: the primary's self-lease is 'records keep
        arriving'. ``primary_lease_seconds <= 0`` disables auto-promotion
        (manual ``oimctl --promote`` only)."""
        while not self._stop.is_set():
            lease = self._effective_primary_lease()
            interval = max(min(lease / 4.0, 1.0), 0.02) if lease > 0 else 1.0
            if self._stop.wait(interval):
                return
            if self.role != STANDBY:
                continue
            with self._lock:
                age = time.monotonic() - self._last_activity
            M.REPL_LAG_SECONDS.set(age)
            if lease > 0 and age > lease and self._may_auto_promote():
                try:
                    # Chaos lever: an auto-promotion attempt lost
                    # mid-flight. Fired HERE, not inside promote(), so
                    # the admin --promote path never raises an injected
                    # fault at an operator, and idempotent no-op calls
                    # never consume an armed times=N budget — times=N
                    # delays convergence by exactly N watchdog ticks.
                    faultinject.fire("registry.promote", role=self.role)
                    self.promote(
                        reason=f"primary lease expired "
                               f"({age:.1f}s > {lease:.1f}s since last "
                               f"record)")
                except faultinject.InjectedFault:
                    pass  # armed registry.promote: retried next tick


class HealthzServer:
    """HTTP probes for k8s. ``GET /healthz`` (readiness): ``200`` when
    this registry is serving and — if it is a STANDBY — its replication
    stream is fresher than ``max_lag_seconds``; ``503`` otherwise, which
    steers clients at the primary. ``GET /livez`` (liveness): ``200``
    whenever the process is serving at all — deliberately lag-blind,
    because restarting a standby for being behind during a primary outage
    would destroy the replica exactly when it is needed. The body is the
    replication status as JSON (or ``{"role": "PRIMARY"}`` for an
    unreplicated registry, which is always healthy)."""

    def __init__(
        self,
        manager: ReplicationManager | None = None,
        port: int = 0,
        host: str = "0.0.0.0",
        max_lag_seconds: float = 30.0,
    ):
        self.manager = manager
        self.max_lag_seconds = max_lag_seconds
        healthz = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                if self.path not in ("/healthz", "/livez"):
                    self.send_error(404)
                    return
                ok, status = healthz.check()
                if self.path == "/livez":
                    ok = True  # serving at all == alive
                body = json.dumps(status).encode()
                self.send_response(200 if ok else 503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr
                pass

        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)

    def check(self) -> tuple[bool, dict]:
        if self.manager is None:
            return True, {"role": PRIMARY, "replicated": False}
        status = self.manager.status()
        ok = (
            status["role"] in (PRIMARY, "LEADER")
            or status["lag_seconds"] <= self.max_lag_seconds
        )
        return ok, status

    def start(self) -> "HealthzServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
