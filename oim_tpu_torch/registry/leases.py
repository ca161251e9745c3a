"""Registry lease table: TTLs over the soft-state KV store.

The reference's registry trusts a controller's one-time registration
forever (pkg/oim-controller registration loop, SURVEY §L3'): a dead
controller leaves a stale ``<id>/address`` that the transparent proxy
happily dials. The lease table is the etcd-TTL / GFS-chunkserver-
heartbeat layer on top of the same KV store: an entry written with
``lease_seconds > 0`` is *live* only until its deadline, renewed by
controller heartbeats; expired entries are hidden from ``GetValues``
(opt-in ``include_stale`` keeps them inspectable for debugging) and the
proxy fast-fails instead of dialing a dead address.

Time is ``time.monotonic`` — wall-clock jumps (NTP steps) must not mass-
expire a healthy fleet. The table never deletes from the backing DB: the
DB stays the record of last-known state, the lease table is the liveness
overlay (both soft state, rebuilt by the heartbeat loop after a registry
restart).
"""

from __future__ import annotations

import threading
import time
from typing import Callable


class Lease:
    __slots__ = ("deadline", "ttl", "expiry_counted")

    def __init__(self, deadline: float, ttl: float):
        self.deadline = deadline
        self.ttl = ttl
        # Expiry is COUNTED (metrics) at most once per live->expired
        # transition, at the first read that observes it stale.
        self.expiry_counted = False


class LeaseTable:
    """Per-path leases on a monotonic clock.

    Paths without a lease are permanent (the pre-lease contract — admin
    keys, tests). ``clock`` is injectable so tests expire leases without
    sleeping.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._leases: dict[str, Lease] = {}
        self._lock = threading.Lock()

    def grant(self, path: str, ttl_seconds: float) -> None:
        """Attach (or refresh) a lease. ttl <= 0 removes any lease,
        making the entry permanent."""
        with self._lock:
            if ttl_seconds <= 0:
                self._leases.pop(path, None)
                return
            self._leases[path] = Lease(
                self._clock() + ttl_seconds, ttl_seconds)

    def drop(self, path: str) -> None:
        """Forget the lease (entry deleted from the DB)."""
        with self._lock:
            self._leases.pop(path, None)

    def renew_path(self, path: str, ttl_seconds: float = 0.0) -> int:
        """Extend exactly one path's lease — O(1), no prefix scan. The
        batched-Heartbeat row renewal: a fleet of 1k rows renewing by
        key must not pay a 1k-entry scan PER KEY (the O(N^2) cliff the
        prefix form hits at production fan-in). Returns 1 when a lease
        was renewed, 0 when the path carries none."""
        now = self._clock()
        with self._lock:
            lease = self._leases.get(path)
            if lease is None:
                return 0
            ttl = ttl_seconds if ttl_seconds > 0 else lease.ttl
            lease.deadline = now + ttl
            lease.ttl = ttl
            lease.expiry_counted = False
            return 1

    def has_lease(self, path: str) -> bool:
        """Whether the path carries a lease at all (live or expired) —
        O(1), the quorum write path's pre-propose existence check."""
        with self._lock:
            return path in self._leases

    def renew(self, prefix: str, ttl_seconds: float = 0.0) -> int:
        """Extend every lease on ``prefix`` or nested under it
        (component-wise, matching the DB's prefix semantics). ttl 0 keeps
        each lease's granted TTL. Returns the number of leases renewed —
        an expired-but-unswept lease renews too (the controller came back
        within the stale-visibility window; its entry simply goes live
        again, same as a re-register)."""
        from oim_tpu_torch.common.pathutil import path_has_prefix

        parts = prefix.split("/")
        now = self._clock()
        renewed = 0
        with self._lock:
            for path, lease in self._leases.items():
                if not path_has_prefix(path, parts):
                    continue
                ttl = ttl_seconds if ttl_seconds > 0 else lease.ttl
                lease.deadline = now + ttl
                lease.ttl = ttl
                lease.expiry_counted = False
                renewed += 1
        return renewed

    def alive(self, path: str) -> bool:
        """True when the path has no lease or an unexpired one."""
        return self.expired_for(path) is None

    def expired_for(self, path: str) -> float | None:
        """Seconds since expiry, or None when live/permanent. Counts the
        live->expired transition exactly once (LEASE_EXPIRIES)."""
        with self._lock:
            lease = self._leases.get(path)
            if lease is None:
                return None
            overdue = self._clock() - lease.deadline
            if overdue <= 0:
                return None
            if not lease.expiry_counted:
                lease.expiry_counted = True
                from oim_tpu_torch.common import events, metrics as M

                M.LEASE_EXPIRIES.inc()
                # Flight recorder: the live->expired transition is THE
                # control-plane incident behind proxy fast-fails, feeder
                # failovers, and routers dropping a replica — stamped
                # with whatever trace first observed it stale.
                events.emit(events.LEASE_EXPIRED, path=path,
                            overdue_s=round(overdue, 3),
                            ttl_s=round(lease.ttl, 3))
            return overdue

    def remaining(self, path: str) -> float | None:
        """Seconds until expiry; None for permanent entries. Negative
        when already expired (how stale the entry is)."""
        with self._lock:
            lease = self._leases.get(path)
            if lease is None:
                return None
            return lease.deadline - self._clock()

    def count(self, prefix: str) -> int:
        """Leases on ``prefix`` or nested under it (component-wise) —
        what a renew of that prefix would touch. The quorum write path
        computes a Heartbeat's ``known`` verdict from this BEFORE
        proposing the renewal (the leader's lease table is committed
        state)."""
        from oim_tpu_torch.common.pathutil import path_has_prefix

        parts = prefix.split("/")
        with self._lock:
            return sum(1 for path in self._leases
                       if path_has_prefix(path, parts))

    def leased_paths(self) -> list[str]:
        """Every path currently carrying a lease (live or expired)."""
        with self._lock:
            return list(self._leases)

    def sweep_expired(self) -> list[str]:
        """Paths whose lease is past its deadline, each counted/emitted
        through the same once-per-transition accounting as a lazy read
        (``expired_for``). The Watch hub's sweeper calls this so expiry
        becomes a PUSH signal — watchers get a deletion the moment a
        sweep observes the lapse, instead of every consumer polling."""
        return [path for path in self.leased_paths()
                if self.expired_for(path) is not None]
